"""K3m, the merge of sorted key lists (``csrc/topk.cu`` ``merge_kernel``),
measured on a CUDA card beyond what ``chip_smoke.py`` holds::

    python -m avenir_tpu_torch.merge_probe [--calls] [--plans]

``--calls`` runs the wrappers (``ops.topk.merge_topk_lists``, and the
keys-out ``merge_topk_keys`` in place into list 0) at the shapes the
port's callers give the merge, on seeded lists made on the card (sorted
unique keys, values that tie across lists, short and empty lists), each
held exact against the plain version: the plan ``merge_plan`` chose, the
call time (``timing.time_ms``) of both forms (the keys-out one timed into
a tensor of its own), the kernel's own device time
(``timing.kernel_device_ms``) and ``torch.topk`` over the same lists laid
side by side.

``--plans`` is the measurement behind ``merge_plan``'s constants: at each
of those shapes every plan of 1 to 32 warps a row and 1 to 8 rows a block
(one staging round), launched through the library (no launch counted),
held exact, by call time over back-to-back launches.

With neither flag, both run.  Prints the card's name and power limit, then
one JSON object a line per measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from .ops import topk
from .timing import kernel_device_ms, time_ms

# (S, nq, k): the serving batches' segments, a segmented ring hop (carry +
# 98), the kNN job's segments, a ring hop at the kNN cell (carry + 8), the
# model axis (12 lists), K3's most segments at one query, odd k (8-byte
# copies), a gather past one block (two rounds), one row of one list
SHAPES = [(128, 1, 16), (128, 8, 16), (128, 64, 16), (99, 512, 16),
          (3, 16384, 16), (9, 4096, 16), (12, 8192, 16), (12, 16384, 16),
          (257, 1, 16), (257, 1, 64), (33, 777, 33), (600, 2, 64),
          (1, 1, 16)]


def make_lists(S: int, nq: int, k: int, seed: int) -> torch.Tensor:
    """``[S, nq, k]`` sorted unique keys on the card: values in [0, 64)
    (ties across lists), index ``s * k + j`` (unique in a row), each list
    cut to a random length of 0 to k keys, ``INT64_MAX`` after it."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    vals = torch.randint(0, 64, (S, nq, k), generator=g, device="cuda")
    idx = torch.arange(S * k, device="cuda").view(S, 1, k)
    keys = torch.sort((vals << 32) | idx, dim=2).values
    n = torch.randint(0, k + 1, (S, nq, 1), generator=g, device="cuda")
    pos = torch.arange(k, device="cuda").view(1, 1, k)
    return torch.where(pos < n, keys, topk._SENT64).contiguous()


def _flat(keys):
    S, nq, k = keys.shape
    return keys.permute(1, 0, 2).reshape(nq, S * k).contiguous()


def calls(card: str) -> None:
    for S, nq, k in SHAPES:
        keys = make_lists(S, nq, k, seed=S * nq + k)
        want = topk.plain_merge_topk(keys)
        got = topk.merge_topk_lists(keys)
        inplace = keys.clone()
        kth = torch.empty(nq, dtype=torch.int32, device="cuda")
        topk.merge_topk_keys(inplace, inplace[0], kth)
        wkeys = topk.plain_merge_topk_keys(keys)
        if not (all(torch.equal(a, b) for a, b in zip(got, want))
                and torch.equal(inplace[0], wkeys)
                and torch.equal(inplace[1:], keys[1:])
                and torch.equal(kth, (wkeys[:, k - 1] >> 32).int())):
            raise AssertionError(f"merge at S={S} nq={nq} k={k} differs "
                                 f"from its plain version")
        plan = topk.merge_plan(S, nq, k, *topk._merge_device(0))
        flat = _flat(keys)
        kern = lambda: topk.merge_topk_lists(keys)
        print(json.dumps({
            "S": S, "nq": nq, "k": k, "plan": plan._asdict(),
            "call_ms": time_ms(kern, 500, warmup_s=0.1),
            "device_ms": kernel_device_ms(kern, 50, "merge_kernel"),
            # into a tensor of its own: in place, a second call would
            # merge list 0's answer with the lists whose keys it repeats
            "keys_out_ms": time_ms(
                lambda: topk.merge_topk_keys(keys, inplace[0], kth), 500),
            "topk_ms": time_ms(lambda: torch.topk(
                flat, k, dim=1, largest=False, sorted=True), 200),
            "card": card}), flush=True)


def plans(card: str) -> None:
    lib = topk._lib()
    _, smem_max = topk._merge_device(0)
    stream = torch.cuda.current_stream().cuda_stream
    for S, nq, k in SHAPES:
        if 8 * S * k > smem_max:
            continue
        keys = make_lists(S, nq, k, seed=S * nq + k)
        want = topk.plain_merge_topk(keys)
        vals = torch.empty((nq, k), dtype=torch.int32, device="cuda")
        idxs = torch.empty_like(vals)
        row = {"S": S, "nq": nq, "k": k, "chosen":
               topk.merge_plan(S, nq, k, *topk._merge_device(0))._asdict(),
               "card": card, "ms": {}}
        for warps in (1, 2, 4, 8, 16, 32):
            for rows in (1, 2, 4, 8):
                smem = 8 * rows * S * k
                if warps * rows > 32 or smem > smem_max:
                    continue
                st = topk._MergePlan(S, nq, k, warps, rows, S, 1, smem,
                                     -(-nq // rows))
                launch = lambda: topk._raise_on(lib.avenir_topk_merge(
                    keys.data_ptr(), ctypes.addressof(st), vals.data_ptr(),
                    idxs.data_ptr(), None, None, stream), "merge probe")
                launch()
                if not (torch.equal(vals, want[0])
                        and torch.equal(idxs, want[1])):
                    raise AssertionError(f"plan {warps} x {rows} at S={S} "
                                         f"nq={nq} k={k} is not exact")
                row["ms"][f"{warps}x{rows}"] = time_ms(launch, 300,
                                                       warmup_s=0.05)
        print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", action="store_true")
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("merge_probe needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    both = not (args.calls or args.plans)
    if args.calls or both:
        calls(card)
    if args.plans or both:
        plans(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
