"""Device milliseconds of the teacher's forward per labeler chunk in the
traced window: the union of the device's operations other than copies,
memsets and K1, over the program's ``teacher/decoder`` span records (one
per chunk).  None without a trace or such records, or where their count
differs from K1's launches: the spans and the launches then do not
describe the same chunks."""

from perfbench.lib import spans


def _is_k1(name):
    return "resize_argmax" in name


def _teacher_op(name):
    return not (name.startswith(("Memcpy", "Memset")) or _is_k1(name))


def read(ctx):
    t = ctx.trace_data
    chunks = len(spans.named(spans.records(ctx), "teacher/decoder"))
    if t is None or not chunks or chunks != t.count_where(_is_k1):
        return None
    return 1e3 * t.seconds_where(_teacher_op) / chunks
