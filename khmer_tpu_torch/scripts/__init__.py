"""Microbenchmarks of the port's kernels (counterparts of scripts/)."""

# ~50 ms of an H100's clock: longer than the host takes to issue a
# benchmark's calls
HOLD_CYCLES = 100_000_000


def _events_ms(fn, reps, hold):
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def cuda_ms(fn, reps=1):
    """Mean time of fn() in ms over `reps` calls issued back to back, by
    CUDA events, after one warm-up call: what a caller sees, the host's
    time to issue a call included where a kernel takes less."""
    return _events_ms(fn, reps, hold=False)


def device_ms(fn, reps=1):
    """As cuda_ms, but a sleep kernel holds the stream while the host
    issues the calls, so only the device's time counts (torch.cuda._sleep,
    a private torch call); a call that waits on the device runs as it is
    issued."""
    return _events_ms(fn, reps, hold=True)


def reset_ms(reset, fn, reps, hold):
    """Mean CUDA-event ms of fn() over `reps` calls, each after reset()
    (outside the events); with `hold`, a sleep kernel holds the stream
    while the call is issued, so only the device's time counts. Returns the
    last call's result too."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        reset()
        torch.cuda.synchronize()
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps, out


def held_ms(calls, before=None):
    """Each of `calls` (functions of no argument) in ms by CUDA events
    around it, issued in order in runs of 256 while a sleep kernel holds
    the stream, so that no event waits on the host: the device's time from
    one event to the next, its gap between launches included (a profiler's
    kernel time leaves that out). before() (e.g. a write that flushes L2),
    where given, is issued ahead of each call, outside its events (in runs
    of 128: the card queues about a thousand launches before the host
    waits). A run whose hold ended before it was issued is issued again
    under a hold twice as long, at most 4 times in all; then it raises."""
    import torch

    run, tries = 256 if before is None else 128, 4
    pairs = []
    for lo in range(0, len(calls), run):
        for attempt in range(tries):
            torch.cuda.synchronize()
            torch.cuda._sleep(HOLD_CYCLES << attempt)
            held = torch.cuda.Event()
            held.record()
            timed = []
            for fn in calls[lo:lo + run]:
                if before is not None:
                    before()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                stop.record()
                timed.append((start, stop))
            if not held.query():
                break
        else:
            raise RuntimeError("the stream's hold ended before calls %d-%d "
                               "were issued, %d times" % (
                                   lo, lo + run - 1, tries))
        pairs += timed
    torch.cuda.synchronize()
    return [start.elapsed_time(stop) for start, stop in pairs]


def host_us(fn, reps=1):
    """Host microseconds per call of fn(), the stream held by a sleep
    kernel so that no call waits on the device."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us
