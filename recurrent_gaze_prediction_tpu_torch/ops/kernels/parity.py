"""Parity checks on the card: the CUDA recurrence kernels against their
plain versions, the counterpart of the JAX package's `ops/pallas/parity.py`.

`convgru_parity()` and `convlstm_parity()` run the SAME params and inputs
through a forward kernel's wrapper (B1, B3) and the plain scan;
`backward_parity()` runs the backward kernels (B2 `convgru_bwd`, B4
`convgru_bwd_mono`, and B4's phases G `convgru_bwd_gates` and W
`convgru_wgrad`) and their plain versions on inputs from a real forward.
Each reports agreement. On a CPU device both sides are the plain versions,
so only a CUDA run checks a kernel (chip_smoke.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import resolve_device
from ..cells import ConvGRU, ConvLSTM
from . import convgru_vjp, convgru_vjp2
from .convgru import convgru_recurrence, convgru_scan, mode_of
from .convlstm import convlstm_scan

# The gate the JAX package puts on its TPU kernel (bf16 production mode):
# loose enough for run-to-run and rounding-order noise, tight enough that a
# wrong gate or a wrong conv shift (corr << 0.99) cannot pass.
BF16_MAX_REL_DELTA = 0.05
MIN_CORR = 0.999
# cell weights of the backward checks: the reference init (1e-4) leaves the
# recurrence ~0, so the cotangents would barely cross the state convs
STATE_STDDEV = 0.05
# the ConvLSTM check's carries c0, h0: nonzero, as the streaming step feeds
# them to the kernel
CARRY_STDDEV = 0.5


def convgru_parity(t: int = 42, b: int = 8, hw: tuple[int, int] = (7, 7),
                   c: int = 512, units: int = 128,
                   compute_dtype=torch.bfloat16, seed: int = 0,
                   device=None) -> dict:
    """Run the kernel and `ConvGRU.scan` on identical inputs at the
    flagship gaze_grcn shapes; return agreement stats.

    Both paths use `compute_dtype`. The kernel keeps its conv results in
    f32 where the plain scan rounds them to the compute dtype, so bf16
    agreement is bounded by bf16 resolution. `max_rel_delta` is measured
    against the hidden-state scale, `corr` over all T*B*H*W*U outputs, and
    `final_h_max_delta` compares the kernel's final state with its ys[-1].
    """
    dev = resolve_device(device)
    h, w = hw
    rng = np.random.RandomState(seed)
    shapes = ConvGRU.init(c, units)
    params = {k: torch.from_numpy(
        rng.randn(*v.shape).astype(np.float32) * 0.1).to(dev)
        for k, v in shapes.items()}
    xs = torch.from_numpy(rng.randn(t, b, h, w, c).astype(np.float32)).to(dev)
    h0 = ConvGRU.zero_state(b, (h, w), units, device=dev)

    with torch.inference_mode():
        _, ys_plain = ConvGRU.scan(params, xs, h0, compute_dtype=compute_dtype)
        h_kernel, ys_kernel = convgru_scan(params, xs, h0,
                                           compute_dtype=compute_dtype)
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "compute_dtype": str(compute_dtype).replace("torch.", ""),
        "shape": {"t": t, "b": b, "h": h, "w": w, "c": c, "units": units},
        **_agreement(ys_kernel, ys_plain),
        "final_h_max_delta": float(
            (h_kernel - ys_kernel[-1]).abs().max().item()),
    }


def convlstm_parity(t: int = 42, b: int = 8, hw: tuple[int, int] = (7, 7),
                    c: int = 512, units: int = 128,
                    compute_dtype=torch.bfloat16, seed: int = 0,
                    device=None) -> dict:
    """Run kernel B3 and `ConvLSTM.scan` on identical inputs at the
    flagship gaze_lstm shapes; return agreement stats.

    Parameters N(0, 0.1) as in the JAX package's gate; the carries c0, h0
    are N(0, CARRY_STDDEV). Beside `convgru_parity`'s stats it reports
    `final_c`: the kernel's c_T against the plain scan's (the JAX kernel
    drops c_T, so the JAX gate has no counterpart)."""
    dev = resolve_device(device)
    h, w = hw
    rng = np.random.RandomState(seed)
    params = {k: torch.from_numpy(
        rng.randn(*v.shape).astype(np.float32) * 0.1).to(dev)
        for k, v in ConvLSTM.init(c, units, (h, w)).items()}
    xs = torch.from_numpy(rng.randn(t, b, h, w, c).astype(np.float32)).to(dev)
    carry0 = tuple(torch.from_numpy(
        (rng.randn(b, h, w, units) * CARRY_STDDEV).astype(np.float32)).to(dev)
        for _ in range(2))

    with torch.inference_mode():
        (c_plain, _), ys_plain = ConvLSTM.scan(params, xs, carry0,
                                               compute_dtype=compute_dtype)
        (c_kernel, h_kernel), ys_kernel = convlstm_scan(
            params, xs, carry0, compute_dtype=compute_dtype)
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "compute_dtype": str(compute_dtype).replace("torch.", ""),
        "shape": {"t": t, "b": b, "h": h, "w": w, "c": c, "units": units},
        **_agreement(ys_kernel, ys_plain),
        "final_h_max_delta": float(
            (h_kernel - ys_kernel[-1]).abs().max().item()),
        "final_c": _agreement(c_kernel, c_plain),
    }


def parity_ok(stats: dict, max_rel_delta: float = BF16_MAX_REL_DELTA) -> bool:
    """The gate: ys (and c_T, where reported) agree to corr >= MIN_CORR and
    `max_rel_delta`, and the final h is exactly ys[-1]."""
    parts = [stats] + ([stats["final_c"]] if "final_c" in stats else [])
    return bool(all(np.isfinite(s["corr"]) and s["corr"] >= MIN_CORR
                    and s["max_rel_delta"] <= max_rel_delta for s in parts)
                and stats["final_h_max_delta"] == 0.0)


def _agreement(kernel: torch.Tensor, plain: torch.Tensor) -> dict:
    k = kernel.float().cpu().numpy().ravel()
    a = plain.float().cpu().numpy().ravel()
    scale = float(np.abs(a).max()) or 1.0
    max_delta = float(np.abs(k - a).max())
    return {"max_delta": max_delta, "max_rel_delta": max_delta / scale,
            "corr": (float(np.corrcoef(k, a)[0, 1]) if a.std() > 0
                     else float("nan"))}


def backward_inputs(t: int = 42, b: int = 8, c: int = 512, units: int = 128,
                    compute_dtype=torch.bfloat16, seed: int = 0,
                    device=None) -> dict:
    """Inputs of the backward kernels from a real forward: cell weights
    N(0, STATE_STDDEV), features N(0, 1), wx from the input-side conv, ys
    from kernel B1 (its plain version on a CPU device), the stage-1 gates
    recomputed from them, and a random cotangent g of ys."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    params = {k: torch.from_numpy((rng.randn(*v.shape) * STATE_STDDEV)
                                  .astype(np.float32)).to(dev)
              for k, v in ConvGRU.init(c, units).items()}
    xs = torch.from_numpy(rng.randn(t, b, 7, 7, c).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.randn(t, b, 7, 7, units).astype(np.float32)).to(
        dev)
    with torch.no_grad():
        fused = ConvGRU.fuse(params)
        wx = ConvGRU.input_gates(fused, xs, compute_dtype)
        h0 = ConvGRU.zero_state(b, (7, 7), units, device=dev)
        _, ys = convgru_recurrence(fused, wx, h0)
        u, r, cand, hprev, rh = convgru_vjp.recompute_gates(
            fused["Uh_zr"], fused["U_c"], wx, h0, ys)
    return {"uzr": fused["Uh_zr"], "uc": fused["U_c"], "wx": wx, "h0": h0,
            "ys": ys, "g": g, "u": u, "r": r, "c": cand, "hprev": hprev,
            "rh": rh}


def backward_kernel_and_plain(kernel: str, x: dict):
    """(kernel call, plain call, output names) of a backward kernel on the
    inputs of `backward_inputs`, as zero-argument functions. Phase W's
    cotangents dzr and da come from B2 (its plain version on a CPU
    device), run once here."""
    if kernel == "convgru_bwd":
        args = (x["u"], x["r"], x["c"], x["hprev"], x["g"], x["uzr"],
                x["uc"], mode_of(x["wx"]))
        return (lambda: convgru_vjp2.dh_bwd(*args),
                lambda: convgru_vjp2.dh_bwd_plain(*args),
                ("dzr", "da", "dh0"))
    if kernel == "convgru_bwd_mono":
        args = (x["uzr"], x["uc"], x["wx"], x["ys"], x["h0"], x["g"])
        return (lambda: convgru_vjp.convgru_bwd(*args),
                lambda: convgru_vjp.convgru_bwd_plain(*args),
                ("dwx", "dh0", "dU_zr", "dU_c"))
    if kernel == "convgru_bwd_gates":
        args = (x["uzr"], x["uc"], x["wx"], x["h0"], x["ys"])
        return (lambda: convgru_vjp.bwd_gates(*args),
                lambda: convgru_vjp.recompute_gates(*args),
                ("u", "r", "c", "hprev", "rh"))
    if kernel == "convgru_wgrad":
        cdt = mode_of(x["wx"])
        with torch.no_grad():
            dzr, da, _ = convgru_vjp2.dh_bwd(x["u"], x["r"], x["c"],
                                             x["hprev"], x["g"], x["uzr"],
                                             x["uc"], cdt)
        args = (x["hprev"], dzr, x["rh"], da, cdt)
        return (lambda: convgru_vjp.wgrad(*args),
                lambda: convgru_vjp.wgrad_plain(*args), ("dU_zr", "dU_c"))
    raise ValueError(f"unknown backward kernel {kernel!r}")


def backward_parity(kernel: str, t: int = 42, b: int = 8, c: int = 512,
                    units: int = 128, compute_dtype=torch.bfloat16,
                    seed: int = 0, device=None) -> dict:
    """Run a backward kernel and its plain version on identical inputs
    from a real forward at the flagship shapes; agreement per output
    (`max_rel_delta` against that output's scale, `corr` over all of
    it)."""
    x = backward_inputs(t, b, c, units, compute_dtype, seed, device)
    run_kernel, run_plain, names = backward_kernel_and_plain(kernel, x)
    with torch.no_grad():
        got, want = run_kernel(), run_plain()
    dev = x["wx"].device
    return {
        "kernel": kernel,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "compute_dtype": str(compute_dtype).replace("torch.", ""),
        "shape": {"t": t, "b": b, "c": c, "units": units},
        "outputs": {n: _agreement(k, a) for n, k, a in zip(names, got, want)},
    }


def backward_parity_ok(stats: dict,
                       max_rel_delta: float = BF16_MAX_REL_DELTA) -> bool:
    return all(np.isfinite(o["corr"]) and o["corr"] >= MIN_CORR
               and o["max_rel_delta"] <= max_rel_delta
               for o in stats["outputs"].values())
