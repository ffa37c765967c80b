"""Job driver: ``python -m avenir_tpu_torch <Job|FQCN> -Dconf.path=<props>
<in> <out> [--device cpu|cuda]``.

The same invocation, ``.properties`` files, schema JSONs and in/out
directory layout as the reference package's ``python -m avenir_tpu``; job
counters print to stderr.  Jobs run on ``cuda:0`` unless ``--device cpu``
asks for the CPU, and fail when there is no card.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

from .core.config import load_job_config, parse_cli_args

# reference driver class -> (job class in models.bayesian, config prefix)
JOBS: Dict[str, tuple] = {
    "org.avenir.bayesian.BayesianDistribution": ("BayesianDistribution", ""),
    "org.avenir.bayesian.BayesianPredictor": ("BayesianPredictor", "bp"),
}


def resolve(name: str) -> tuple:
    if name in JOBS:
        return JOBS[name]
    for fq, spec in JOBS.items():
        if fq.rsplit(".", 1)[1] == name:
            return spec
    raise SystemExit(f"unknown job: {name}\nknown jobs:\n  "
                     + "\n  ".join(sorted(JOBS)))


def _extract_device(argv):
    """Pull ``--device X`` / ``--device=X`` out of an argument vector."""
    out, device, i = [], None, 0
    while i < len(argv):
        a = argv[i]
        if a == "--device":
            if i + 1 >= len(argv):
                raise SystemExit("--device requires a value (cpu or cuda)")
            device = argv[i + 1]
            i += 2
            continue
        if a.startswith("--device="):
            device = a.partition("=")[2]
        else:
            out.append(a)
        i += 1
    return out, device


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m avenir_tpu_torch <JobClass> "
              "-Dconf.path=<props> <in> <out> [--device cpu|cuda]\n"
              "known jobs:\n  " + "\n  ".join(sorted(JOBS)), file=sys.stderr)
        return 2
    job_name, rest = argv[0], argv[1:]
    clsname, prefix = resolve(job_name)
    rest, device = _extract_device(rest)
    defines, positional = parse_cli_args(rest)
    if len(positional) < 2:
        print("expected <input path> <output path>", file=sys.stderr)
        return 2
    config = load_job_config(defines, prefix)
    from .models import bayesian
    job = getattr(bayesian, clsname)(config, device=device)
    counters = job.run(positional[0], positional[1])
    print(counters.format(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
