"""Seeded telecom-churn rows: the port's copy of
``avenir_tpu/datagen/generators.py::gen_telecom_churn``.

The same seed gives the same rows as the reference package's generator
(both draw from ``numpy.random.default_rng``).  Command line::

    python -m avenir_tpu_torch.datagen telecom_churn N [--seed S] [--out FILE]
"""

from __future__ import annotations

import os
import sys
from typing import List

import numpy as np


def _clip_int(rng, mean, sd, lo, hi, size=None):
    v = np.rint(rng.normal(mean, sd, size)).astype(int)
    return np.clip(v, lo, hi)


def gen_telecom_churn(n: int, seed: int = 42) -> List[List[str]]:
    """Rows ``id,plan,minUsed,dataUsed,csCall,csEmail,network,churned``
    (resource/churn_nb/teleComChurn.json), ~20% churners from three
    planted causes: bad plan with heavy usage; excess customer-service
    contact; small network."""
    rng = np.random.default_rng(seed)
    rows = []
    min_usage = [(600, 50), (1200, 300)]
    data_usage = [(200, 50), (500, 150)]
    cs_call = [(4, 1), (8, 2)]
    cs_email = [(6, 2), (10, 3)]
    network = [(3, 1), (6, 2)]

    def draw(dist, i, lo, hi):
        m, s = dist[i]
        return int(_clip_int(rng, m, s, lo, hi))

    for i in range(n):
        cust_id = f"C{seed:02d}{i:07d}"
        churn = rng.integers(1, 100) > 80
        if churn:
            case = rng.integers(1, 4)
            churned = "Y"
            if case == 1:        # bad plan, heavy usage
                plan = "planA"
                mu = draw(min_usage, 1, 0, 2200)
                du = draw(data_usage, 1, 0, 1000)
                cc = draw(cs_call, 0, 0, 14)
                ce = draw(cs_email, 0, 0, 22)
                nw = draw(network, 0, 0, 12)
            elif case == 2:      # too many CS contacts
                plan = "planB"
                mu = draw(min_usage, 1, 0, 2200)
                du = draw(data_usage, 1, 0, 1000)
                cc = max(draw(cs_call, 1, 0, 14), 6)
                ce = max(draw(cs_email, 1, 0, 22), 8)
                nw = draw(network, 0, 0, 12)
            else:                # small network
                plan = "planB"
                mu = min(draw(min_usage, 1, 0, 2200) + 200, 2200)
                du = min(draw(data_usage, 1, 0, 1000) + 100, 1000)
                cc = draw(cs_call, 0, 0, 14)
                ce = draw(cs_email, 0, 0, 22)
                nw = draw(network, 0, 0, 12)
        else:
            churned = "N"
            plan = "planA" if rng.random() < 0.5 else "planB"
            p = 0 if plan == "planA" else 1
            mu = draw(min_usage, p, 0, 2200)
            du = draw(data_usage, p, 0, 1000)
            cc = min(draw(cs_call, 0, 0, 14), 2)
            ce = min(draw(cs_email, 0, 0, 22), 3)
            nw = draw(network, 1, 0, 12)
        rows.append([cust_id, plan, str(mu), str(du), str(cc), str(ce),
                     str(nw), churned])
    return rows


PRESETS = {"telecom_churn": gen_telecom_churn}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    usage = ("usage: python -m avenir_tpu_torch.datagen telecom_churn N "
             "[--seed S] [--out FILE]")
    if not argv or argv[0] not in PRESETS:
        print(usage, file=sys.stderr)
        return 2
    fn, rest = PRESETS[argv[0]], argv[1:]
    seed, out, sizes = None, None, []
    try:
        i = 0
        while i < len(rest):
            if rest[i] == "--seed":
                seed = int(rest[i + 1]); i += 2
            elif rest[i] == "--out":
                out = rest[i + 1]; i += 2
            elif rest[i].startswith("--"):
                raise ValueError(f"unknown option {rest[i]}")
            else:
                sizes.append(int(rest[i])); i += 1
        if len(sizes) != 1:
            raise ValueError(f"expected one size, got {len(sizes)}")
    except (IndexError, ValueError) as e:
        print(f"bad arguments: {e}\n{usage}", file=sys.stderr)
        return 2
    rows = fn(sizes[0], **({} if seed is None else {"seed": seed}))
    text = "\n".join(",".join(r) for r in rows) + "\n"
    if out:
        d = os.path.dirname(out)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(out, "w") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
