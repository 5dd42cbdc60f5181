"""`best_chunk_steps_per_s.train`: the steps of one chunk over the
shortest wall time of the window's untraced chunks, each ended by its
loss read-back. Host noise only slows a chunk, so the fastest is steady
from run to run where the window's rate is not."""

LAYER = "train loop: train/loops.py masker_chunk"
UNIT = "steps/s"
MOVES = "train_steps_per_s"


def read(ctx):
    best = ctx["layer"].get("best_chunk_s")
    return None if not best else ctx["layer"]["chunk_steps"] / best
