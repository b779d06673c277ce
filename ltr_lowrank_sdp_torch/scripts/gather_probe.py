"""Time K13, the gather-sum kernel, beside PyTorch's gather and its bound.

The twin of ``scripts/pallas_gather_probe.py``: the same arguments and one
JSON line.

    python -m ltr_lowrank_sdp_torch.scripts.gather_probe [N [M [R]]] [--device cpu]

Y (N, R) float32 and idx (M,) int32 in [0, N) are drawn from a seeded
``torch.Generator``; ``out (1, R) = sum_i Y[idx[i]]`` is computed by K13
(``kernels.gather_rowsum``) and by one PyTorch call,
``Y.index_select(0, idx).sum(0, keepdim=True)`` (the kernel's plain version
and the probe's own ``f_xla`` baseline).  ``kernel_ok``: the kernel within
``TOL`` of the largest magnitude of the same sum evaluated in float64.
Times by CUDA events over ``ITERS`` calls, L2-warm (Y is 1 MB at the
defaults).  ``bound_ms``: the compulsory bytes (idx, Y and out once) over
3.35 TB/s; ``gathered_bytes``: the M x R x 4 bytes the gather reads, served
from L2.  On the card by default; ``--device cpu`` runs the plain version
and says so (``"path"``), with no time.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from .. import resolve_device
from ..ops import kernels as K

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
TOL = 1e-5                     # max |kernel - float64| / max |float64|
ITERS = 50
SLEEP_CYCLES = 50_000_000      # holds the stream while the host issues


def time_ms(fn, iters: int = ITERS) -> float:
    """Mean device time of one call by CUDA events, after a warm-up; a sleep
    kernel queued first keeps host issue time out of the window."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def probe_inputs(N: int, M: int, R: int, device, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    Y = torch.randn((N, R), generator=g, dtype=torch.float32)
    idx = torch.randint(0, N, (M,), generator=g, dtype=torch.int32)
    return Y.to(device), idx.to(device)


ZIPF_S = 1.1                   # the exponent of skewed_indices' Zipf draw


def skewed_indices(N: int, M: int, kind: str, device, seed: int = 0):
    """M int32 indices in [0, N) with repeats: ``"equal"``, every index the
    same (N // 2); ``"zipf"``, index k drawn with weight 1 / (k + 1)^ZIPF_S
    from a seeded ``torch.Generator``."""
    if kind == "equal":
        return torch.full((M,), N // 2, dtype=torch.int32, device=device)
    if kind != "zipf":
        raise ValueError(f"unknown index skew {kind!r}")
    g = torch.Generator().manual_seed(seed)
    w = torch.arange(1, N + 1, dtype=torch.float64) ** -ZIPF_S
    return torch.multinomial(w, M, replacement=True, generator=g).to(
        torch.int32).to(device)


def probe(N: int = 8192, M: int = 262144, R: int = 32,
          device=None) -> dict:
    dev = resolve_device(device)
    Y, idx = probe_inputs(N, M, R, dev)
    ref = K.gather_rowsum_plain(Y.double(), idx)
    res = {"N": N, "M": M, "R": R,
           "bound_ms": (M * 4 + N * R * 4 + R * 4) / HBM_BYTES_PER_S * 1e3,
           "gathered_bytes": M * R * 4}
    if dev.type == "cpu":
        out = K.gather_rowsum(Y, idx)
        err = float((out.double() - ref).abs().max())
        res.update(device="cpu", path="plain version (CPU tensors)",
                   torch_gather_ms=None, kernel_ok=None,
                   kernel_gather_ms=None, plain_max_abs_err=err)
        return res
    out = K.gather_rowsum(Y, idx)
    torch.cuda.synchronize()
    err = float((out.double() - ref).abs().max())
    scale = float(ref.abs().max())
    again = K.gather_rowsum(Y, idx)
    res.update(
        device=torch.cuda.get_device_name(dev), path="kernel K13",
        torch_gather_ms=time_ms(lambda: K.gather_rowsum_plain(Y, idx)),
        kernel_ok=bool(err <= TOL * max(scale, 1e-30)
                       and torch.equal(out, again)),
        kernel_gather_ms=time_ms(lambda: K.gather_rowsum(Y, idx)),
        max_abs_err=err, max_abs_ref=scale)
    return res


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sizes", nargs="*", type=int, metavar="N M R")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain version (default: the GPU)")
    args = ap.parse_args(argv)
    if len(args.sizes) > 3:
        ap.error("at most three sizes: N M R")
    sizes = dict(zip(("N", "M", "R"), args.sizes))
    res = probe(**sizes, device=args.device)
    print(json.dumps(res), flush=True)
    return 0 if res["kernel_ok"] in (True, None) else 1


if __name__ == "__main__":
    sys.exit(main())
