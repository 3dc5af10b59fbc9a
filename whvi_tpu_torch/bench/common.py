"""What the kernel benchmarks share: seeded operands, the header line,
rates and errors."""

from __future__ import annotations

import json
import math
import time

import numpy as np
import torch

from whvi_tpu_torch.utils.profiling import H100_HBM_GBPS, card, cuda_ms, require_cuda

__all__ = [
    "bound_ms", "device_name", "emit", "fused_ops", "header", "operands", "rates", "rel_err",
    "time_us", "unique_bytes",
]

WARM_S = 0.2  # seconds of graph replays before timing


def operands(D: int, B: int, seed: int = 0, dtype=torch.float32):
    """``(s1, u, s2, x)`` on the card: standard normal ``(D,)`` diagonals
    and a ``(B, D)`` input of ``dtype`` (float32, or bfloat16 storage),
    made with numpy from ``seed``."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(D) for _ in range(3)] + [rng.randn(B, D)]
    return [torch.from_numpy(a.astype(np.float32)).to("cuda", dtype) for a in arrays]


def rel_err(got, want) -> float:
    """``max |got - want| / max |want|``; the shapes must agree."""
    if got.shape != want.shape:
        raise ValueError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return ((got - want).abs().max() / want.abs().max()).item()


def time_us(fn, iters: int) -> float:
    """Device microseconds per call of ``fn``.

    ``iters`` calls are captured into one CUDA graph and the graph is
    timed (CUDA events, median of 5 replays), so the wrappers' host cost,
    tens of microseconds a call, does not stand in for the kernels' time.
    The graph first replays for WARM_S seconds: an idle card sits at a
    low clock (345 MHz on the H100 before a run). What ``fn`` reads must
    stay alive while the graph is in use.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # builds, loads and warms off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    end = time.perf_counter() + WARM_S
    while time.perf_counter() < end:
        graph.replay()
        torch.cuda.synchronize()
    return cuda_ms(graph.replay, reps=1, rounds=5) * 1e3 / iters


def rates(B: int, D: int, us: float, element_size: int = 4) -> dict:
    """The streaming rate of a call that reads x and writes y once
    (``2 * B * D * element_size`` bytes: 4 in fp32 storage, 2 in bf16),
    and its share of the H100's 3.35 TB/s."""
    gbps = 2 * B * D * element_size / (us * 1e-6) / 1e9
    return {"GBps": gbps, "hbm_frac": gbps / H100_HBM_GBPS}


def unique_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements of ``t``: an expanded (stride-0) axis
    is one copy, as a kernel that reads each input once reads it."""
    return t.element_size() * math.prod(n for n, s in zip(t.shape, t.stride()) if s != 0)


def bound_ms(inputs, outputs, ops: float, peak_flops: float) -> tuple[float, str]:
    """The least time an H100 could take for a call, and what sets it: the
    larger of its bytes (each input read once, each output written once)
    over 3.35 TB/s and its ``ops`` over ``peak_flops``."""
    nbytes = sum(unique_bytes(t) for t in (*inputs, *outputs))
    t_bytes = nbytes / (H100_HBM_GBPS * 1e9) * 1e3
    t_ops = ops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_ops(D: int, rows: int) -> int:
    """Operations of one fused product ``s1 * H(u * H(s2 * x))`` over
    ``rows`` rows: two transforms of D log2 D adds and three diagonal
    products an element (fp32 CUDA cores; the bf16 mode's roundings are
    conversions, not operations)."""
    return rows * (2 * D * int(math.log2(D)) + 3 * D)


def device_name(device: torch.device) -> str:
    """What a result row names its device: the card's name, or "cpu"."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def emit(row: dict) -> dict:
    print(json.dumps(row), flush=True)
    return row


def header(tool: str) -> dict:
    """Refuse to run without a card, turn TF32 off (the plain versions'
    fp32 matmuls stay fp32), and print and return the first line."""
    require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return emit({
        "tool": tool,
        "card": card(),
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "allow_tf32": False,
    })
