"""Gradient checks of the port's FWHT and WHVI product, backend by backend.

Counterpart of ``benchmarks/grad_check.py``. Backends (the JAX names in
brackets):

  butterfly  ``torch.autograd.gradcheck`` and ``gradgradcheck`` in float64
             on ``ops.hadamard.fwht``, the radix-2 butterflies (JAX
             ``fwht_butterfly``): forward and reverse mode, and second
             order (JAX's ``check_grads(order=2, modes=["fwd", "rev"])``).
             ``fast_mode``: each derivative is checked along random
             directions against finite differences, as ``check_grads``
             checks its JVPs and VJPs.
  kron       the same on ``ops.hadamard.fwht_kron``.
  kernel     [pallas] the VJP of ``WhviMulFunction`` (K2 forward, K3
             backward) and of ``FwhtFunction`` (K4 forward and backward)
             against the plain versions' on the same inputs: in fp32 against
             autograd through ``fused_plain`` / ``fwht_plain`` (GRAD_TOL;
             the kernels add what the plain versions add), in the bf16
             precision against ``vjp_plain``, the plain backward rounded
             where the kernels round (``fwht_cuda.bf16_tol``; autograd
             through the rounded forward would not round the backward's
             transforms). JAX allows rtol and atol 1e-2 here. On the card;
             with ``--cpu`` the Functions' CPU path, their plain versions,
             and the row says so.
  f64        [cpp] the self-adjointness ``<H x, y> = <x, H y>`` of the
             float64 ``fwht`` at rtol 1e-10 (the JAX check of its C++
             oracle, which the port does not import).

Every backend runs on ``--dim`` x ``--batch`` operands from numpy seeds,
on the card unless ``--cpu``; one JSON row each, ``"ok": true``, or it
raises. The first line names the card and its power limit (or the CPU).

Run: python -m whvi_tpu_torch.bench.grad_check [--backend butterfly|kron|kernel|f64|all]
    [--dim 64] [--batch 4] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from whvi_tpu_torch.bench.common import emit, header
from whvi_tpu_torch.ops import fwht_cuda as fc
from whvi_tpu_torch.ops.hadamard import fwht, fwht_kron

__all__ = ["BACKENDS", "GRAD_TOL", "SELF_ADJOINT_RTOL", "check", "main"]

BACKENDS = ("butterfly", "kron", "kernel", "f64")
GRAD_TOL = 1e-5  # fp32 kernels against their plain versions: the same adds
SELF_ADJOINT_RTOL = 1e-10


def _randn(seed: int, *shape, dtype=torch.float64, device="cpu") -> torch.Tensor:
    a = np.random.RandomState(seed).randn(*shape)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    return ((got - want).abs().max() / want.abs().max()).item()


def _transform_grads(fn, x) -> None:
    """First and second derivatives of ``fn`` at ``x`` (float64), forward
    and reverse mode; raises ``GradcheckError`` on a mismatch."""
    x = x.clone().requires_grad_()
    torch.autograd.gradcheck(fn, (x,), fast_mode=True, check_forward_ad=True)
    torch.autograd.gradgradcheck(fn, (x,), fast_mode=True, check_fwd_over_rev=True)


def _kernel_grads(dim: int, batch: int, device) -> dict:
    """Errors of the autograd Functions' VJPs against the plain versions',
    fp32 and the bf16 precision, each held at its tolerance."""
    s1, u, s2, x, g = (_randn(k, *((dim,) if k < 3 else (batch, dim)), dtype=torch.float32,
                              device=device) for k in range(1, 6))
    errs = {}
    for precision in ("fp32", "bf16"):
        leaves = [a.clone().requires_grad_() for a in (s1, u, s2, x)]
        got = torch.autograd.grad(fc.WhviMulFunction.apply(*leaves, precision), leaves, g)
        if precision == "fp32":
            plain = [a.clone().requires_grad_() for a in (s1, u, s2, x)]
            want = torch.autograd.grad(fc.fused_plain(*plain, False)[0], plain, g)
            tols = (GRAD_TOL,) * 4
        else:
            want = fc.vjp_plain(s1, u, s2, x, g, "bf16")
            tol1, tol2 = fc.bf16_tol(dim, transform=1), fc.bf16_tol(dim)
            tols = (tol2, tol1, tol2, tol2)  # du sums the first transform's products
        for name, a, b, tol in zip(("s1", "u", "s2", "x"), got, want, tols):
            err = _err(a, b)
            if not err <= tol:
                raise AssertionError(f"WhviMulFunction {precision} d{name}: {err:.3e} > {tol:.3e}")
            errs[f"whvi_mul_{precision}_d{name}"] = err
    xl, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    (got,) = torch.autograd.grad(fc.FwhtFunction.apply(xl), xl, g)
    (want,) = torch.autograd.grad(fc.fwht_plain(xp), xp, g)
    err = _err(got, want)
    if not err <= GRAD_TOL:
        raise AssertionError(f"FwhtFunction dx: {err:.3e} > {GRAD_TOL:.3e}")
    errs["fwht_fp32_dx"] = err
    return errs


def check(backend: str, dim: int, batch: int, device) -> dict:
    """One backend's check on ``device``: its row, or it raises."""
    device = torch.device(device)
    row = {"backend": backend, "dim": dim, "batch": batch, "device": str(device)}
    if backend in ("butterfly", "kron"):
        _transform_grads(fwht if backend == "butterfly" else fwht_kron,
                         _randn(0, batch, dim, device=device))
        row["check"] = "gradcheck and gradgradcheck, float64, fast_mode, forward and reverse"
    elif backend == "kernel":
        before, realigned = dict(fc.LAUNCHES), fc.REALIGNED
        row["errors"] = _kernel_grads(dim, batch, device)
        row["tol"] = {"fp32": GRAD_TOL, "bf16": fc.bf16_tol(dim, transform=1)}
        row["route"] = "cpu: the plain versions" if device.type == "cpu" else "cuda: K2, K3, K4"
        row["launches"] = {k: v - before[k] for k, v in fc.LAUNCHES.items() if v > before[k]}
        row["realigned"] = fc.REALIGNED - realigned
    elif backend == "f64":
        x, y = _randn(0, batch, dim, device=device), _randn(1, batch, dim, device=device)
        lhs, rhs = torch.sum(fwht(x) * y).item(), torch.sum(x * fwht(y)).item()
        if not abs(lhs - rhs) <= SELF_ADJOINT_RTOL * abs(rhs):
            raise AssertionError(f"<Hx, y> = {lhs!r} but <x, Hy> = {rhs!r}")
        row["check"] = f"<Hx, y> = <x, Hy> in float64, rtol {SELF_ADJOINT_RTOL}"
    else:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    row["ok"] = True
    return emit(row)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", choices=[*BACKENDS, "all"], default="all",
                    help="kernel is the JAX script's pallas, f64 its cpp")
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernel backend checks the plain versions)")
    args = ap.parse_args(argv)
    if args.cpu:
        emit({"tool": "grad_check", "device": "cpu"})
        device = torch.device("cpu")
    else:
        header("grad_check")
        device = torch.device("cuda", 0)
    backends = BACKENDS if args.backend == "all" else (args.backend,)
    return [check(b, args.dim, args.batch, device) for b in backends]


if __name__ == "__main__":
    main()
