"""Device ms of the gradients' all-reduce per optimizer step, on rank 0: the
device events launched inside the profiled update's `ppo.update.allreduce`
spans (the flat all-reduce of `ppo.apply_gradients`, NCCL's kernels over
the data axis), over the number of `ppo.update.minibatch` spans. None where
the program records no such span."""

from benchmark.launched import per_span


def read(ctx):
    return per_span(ctx, "update", ("ppo.update.allreduce",), "ppo.update.minibatch")
