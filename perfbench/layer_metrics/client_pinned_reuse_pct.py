"""Share of the edge client's pinned downloads in the traced window that
reused a block of PyTorch's caching host allocator: 100 x (1 - the
program's ``network/pinned_fresh`` records over its
``network/pinned_download`` records).  None without such records (a
program that downloads the ids into pageable memory)."""

from perfbench.lib import spans


def read(ctx):
    recs = spans.records(ctx)
    downloads = len(spans.named(recs, "network/pinned_download"))
    if not downloads:
        return None
    fresh = len(spans.named(recs, "network/pinned_fresh"))
    return 100.0 * (1.0 - fresh / downloads)
