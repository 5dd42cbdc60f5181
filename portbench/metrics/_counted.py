"""The device time a batch of the kernels one kind of layer launches,
where the program counts that kind's layers a forward (`model.<kind>`)
and its critic frames (`model.critic_frames`): None where it keeps no
such counters, or where the kernels counted are not a whole multiple of
those layers over the traced batches."""
from portbench.lib.trace import is_kernel
from portbench.metrics._program import counters


def per_batch_s(ctx, counter: str, names):
    s, lay, c = ctx["summary"], ctx["layer"], counters()
    if s is None or not c or not c.get(counter) \
            or not c.get("model.critic_frames"):
        return None
    batch = lay["batch"]
    per_forward = c[counter] * batch / c["model.critic_frames"]
    batches = lay["frames_traced"] / batch
    match = is_kernel(names)
    n = s.device_count(match)
    if n == 0 or n % round(per_forward * batches):
        return None
    return s.device_time_s(match) / batches
