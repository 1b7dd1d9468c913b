"""Microbenchmarks of the port's kernels (counterparts of scripts/)."""


def cuda_ms(fn, reps=1):
    """Mean device time of fn() in ms over `reps` calls, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps
