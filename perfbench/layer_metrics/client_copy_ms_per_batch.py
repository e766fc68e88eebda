"""Device milliseconds of host-to-device and device-to-host copies per
batch of the traced window."""


def read(ctx):
    t = ctx.trace_data
    if t is None or not ctx.traced_window["attempted"]:
        return None
    copies = t.seconds_where(lambda name: name.startswith("Memcpy"))
    return 1e3 * copies / ctx.traced_window["attempted"]
