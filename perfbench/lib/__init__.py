"""The harness's own pieces: seeds, weights, frames, traffic, the trace."""
