"""`ops_per_step.train`: device operations (kernels, copies, fills) per
masker step of the traced chunk (`train/loops.py:masker_chunk`)."""

LAYER = "train loop: train/loops.py masker_chunk"
UNIT = "ops"
MOVES = "train_steps_per_s"


def read(ctx):
    s = ctx["summary"]
    if s is None or s.device_count() == 0:
        return None
    return s.device_count() / ctx["layer"]["steps_traced"]
