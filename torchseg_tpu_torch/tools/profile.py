"""Profiling and tracing on ``torch.profiler`` (counterpart of
torchseg_tpu/tools/profile.py, which reads XLA's xplane; the reference's
ModelHook timing layer, furnace/tools/benchmark/compute_speed.py:42-44,
model_hook.py:43-114).

``trace(logdir)`` writes a Chrome trace of every CPU op and device kernel
the block runs, ``annotate(name)`` adds a named range, and
``device_memory_profile(path)`` dumps the CUDA caching allocator's
snapshot.  ``collect_op_times`` runs a function under the profiler and
returns the device kernels with their device time (on the CPU, where no
kernel runs, the CPU ops with their CPU time, so tests and card runs share
one code path); ``top_ops_table`` and ``print_op_report`` render them as
the reference reporter's table.  JAX's ``start_server`` (a live xprof
attach) has no counterpart.
"""

import contextlib
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

# device-side entries the profiler records as if they were kernels (a
# scheduled profile's steps, DDP's forward, the optimizer's step, CUPTI's
# own buffer requests)
ANNOTATIONS = ("ProfilerStep", "DistributedDataParallel", "Optimizer.",
               "Activity Buffer Request")


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write ``logdir/trace_<time>.json`` (Chrome
    trace format: chrome://tracing, Perfetto, or TensorBoard's profile
    plugin)."""
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}.json"))


def annotate(name: str):
    """A named range inside a trace (shows up on the timeline)."""
    return record_function(name)


def start_server(port: int = 9012):
    """JAX's live profiling server (``jax.profiler.start_server``) has no
    torch.profiler counterpart: profile a window with ``trace``."""
    raise NotImplementedError(
        "torch.profiler has no live-attach server; wrap the window to "
        "profile in tools.profile.trace(logdir) instead")


def device_memory_profile(path: str):
    """Dump the CUDA caching allocator's snapshot (``torch.cuda.memory.
    _dump_snapshot``: every live block and, when recording was on, its
    allocation stack; viewable at pytorch.org/memory_viz)."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_profile needs a CUDA device")
    torch.cuda.memory._dump_snapshot(path)
    return path


# idle seconds at each edge of ``collect_op_times``' window on a card: a
# session keeps only the device activity inside its window, and a
# kernel's timestamp has been seen ~0.1 ms off its launch's on the host
# clock, so the kernels of a short window sat at its edges and were lost
PAD_S = 0.05


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _pad():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        time.sleep(PAD_S)


def collect_op_times(fn, *args, runs: int = 3, logdir: str = None):
    """Run ``fn(*args)`` once to warm up (and, on a card, a throwaway
    profiler session: a process's first one has been seen to drop device
    events), then ``runs`` times under the profiler.  Returns ``(total_ms,
    ops)``: ``ops`` maps each device kernel to its mean device ms a run and
    ``total_ms`` is their sum (on the CPU, where no kernel runs, the CPU
    ops by self time; ``total_ms`` None).  On a card the window idles
    ``PAD_S`` at each edge.  ``logdir``: also write the Chrome trace
    there."""
    fn(*args)
    _sync()
    if torch.cuda.is_available():
        with profile(activities=_activities()):
            _sync()
    with profile(activities=_activities()) as prof:
        _pad()
        for _ in range(runs):
            fn(*args)
            _sync()
        _pad()
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "op_times.json"))
    ops = {}
    for evt in prof.key_averages():
        # kernels only: a CPU op's entry carries its kernels' time too
        if (evt.device_type == DeviceType.CUDA
                and evt.self_device_time_total > 0
                and not evt.key.startswith(ANNOTATIONS)):
            ops[evt.key] = evt.self_device_time_total / 1e3 / runs
    if ops:
        return sum(ops.values()), ops
    for evt in prof.key_averages():
        if evt.self_cpu_time_total > 0:
            ops[evt.key] = evt.self_cpu_time_total / 1e3 / runs
    return None, ops


def top_ops_table(ops: dict, n: int = 20) -> str:
    """The top-n ops by time as the reference reporter's table (duration
    and percentage columns, reporter.py:22-93)."""
    total = sum(ops.values()) or 1.0
    rows = sorted(ops.items(), key=lambda kv: -kv[1])[:n]
    width = max((len(nm) for nm, _ in rows), default=4)
    lines = [f"{'op':<{width}}  {'ms':>9}  {'%':>6}"]
    lines += [
        f"{nm:<{width}}  {t:9.3f}  {100 * t / total:6.2f}"
        for nm, t in rows
    ]
    lines.append(
        f"{'total (all ' + str(len(ops)) + ' ops)':<{width}}  "
        f"{total:9.3f}  {100.0:6.2f}"
    )
    return "\n".join(lines)


def print_op_report(fn, *args, runs: int = 3, n: int = 20):
    """One-call per-op runtime report; returns (total_ms, ops)."""
    total_ms, ops = collect_op_times(fn, *args, runs=runs)
    if total_ms is not None:
        print(f"device kernel time: {total_ms:.3f} ms/run")
    else:
        print("no device kernels ran: CPU ops by self time")
    print(top_ops_table(ops, n))
    return total_ms, ops
