"""Run a reference runbook through the port.

A runbook (``resource/<name>/run.sh`` or ``run.py``) drives the reference
package: ``python -m avenir_tpu <Job> ...``, ``python -m
avenir_tpu.datagen ...``, or in Python ``from avenir_tpu.cli import main
as job``.  :func:`port_runbook` copies the runbook's directory and
rewrites those command lines and imports to the port's, adding
``--device <device>`` to every job when a device is given;
:func:`run_runbook` runs the copy (or an unchanged copy, for the
reference) in a subprocess from its own directory.  Command line::

    python -m avenir_tpu_torch.runbook <runbook dir> <scratch dir> [--device cpu]
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from typing import Callable, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# `-m avenir_tpu <args>` as a command (not the datagen module)
_SHELL_JOB = re.compile(r"-m avenir_tpu (.*?)[ \t]*$", re.M)


def _rewrite_shell(text: str, device: Optional[str]) -> str:
    text = text.replace("-m avenir_tpu.datagen",
                        "-m avenir_tpu_torch.datagen")
    flag = f" --device {device}" if device else ""
    return _SHELL_JOB.sub(lambda m: f"-m avenir_tpu_torch {m.group(1)}"
                          f"{flag}", text)


def _rewrite_python(text: str, device: Optional[str]) -> str:
    job = ("from avenir_tpu_torch.cli import main as _port_main\n\n\n"
           "def job(argv):\n"
           f"    return _port_main(list(argv) + {['--device', device]!r})\n"
           if device else
           "from avenir_tpu_torch.cli import main as job\n")
    text = text.replace("from avenir_tpu.cli import main as job\n", job)
    text = text.replace("from avenir_tpu.core import ",
                        "from avenir_tpu_torch.core.io import ")
    return text.replace("from avenir_tpu.datagen import ",
                        "from avenir_tpu_torch.datagen import ")


def port_runbook(src: str, dst: str, device: Optional[str] = None,
                 port: bool = True,
                 edit: Optional[Callable[[str], str]] = None) -> str:
    """Copy the runbook directory ``src`` to ``dst`` with its ``run.sh``
    or ``run.py`` rewritten to drive the port (``port=False`` keeps the
    reference's commands); ``edit`` is then applied to the script's text.
    Returns the script's path.  Raises when a reference invocation is left
    over after the port's rewrite.  A ``work/`` left in ``src`` by an
    earlier run is not copied."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("work"))
    for name, rewrite in (("run.sh", _rewrite_shell),
                          ("run.py", _rewrite_python)):
        path = os.path.join(dst, name)
        if not os.path.exists(path):
            continue
        with open(path) as fh:
            text = fh.read()
        if port:
            text = rewrite(text, device)
            left = re.findall(r"avenir_tpu(?!_torch)\b[^\n]*", text)
            if left:
                raise ValueError(f"{path}: reference invocations left "
                                 f"after the rewrite: {left}")
        if edit is not None:
            text = edit(text)
        with open(path, "w") as fh:
            fh.write(text)
        return path
    raise FileNotFoundError(f"{src} holds no run.sh or run.py")


def run_runbook(src: str, dst: str, device: Optional[str] = None,
                port: bool = True, timeout: float = 900.0,
                env: Optional[dict] = None,
                edit: Optional[Callable[[str], str]] = None) -> str:
    """Run the runbook ``src`` from a copy at ``dst``: the port's rewrite
    (``port=True``) or the reference's script, each with ``edit``
    applied.  Returns its standard output and error; raises with their
    tail when it exits non-zero."""
    script = port_runbook(src, dst, device, port=port, edit=edit)
    paths = [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]
    run_env = dict(os.environ, PYTHON=sys.executable,
                   PYTHONPATH=os.pathsep.join(paths))
    run_env.update(env or {})
    cmd = (["bash", script] if script.endswith(".sh")
           else [sys.executable, script])
    proc = subprocess.run(cmd, env=run_env, capture_output=True, text=True,
                          timeout=timeout)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{script} exited {proc.returncode}:\n"
                           f"{out[-4000:]}")
    return out


def price_optimize_edit(text: str) -> str:
    """The scratch edit ``resource/price_optimize/run.py`` needs in both
    packages: its first ``write_output("work/in", ...)`` leaves a
    ``_MANIFEST``, and the round's ``inc_return<N>.txt`` written beside it
    is then refused by the reader's validation (``TornArtifactError: part
    inc_return1.txt is not in _MANIFEST``) before any round completes.
    Removing that manifest before the rounds lets the loop run as the
    tutorial describes; later rounds copy a bare part file in."""
    loop = "for rnd in range(1, rounds + 1):"
    if text.count(loop) != 1:
        raise ValueError("price_optimize/run.py: round loop not found")
    return text.replace(loop, 'os.unlink("work/in/_MANIFEST")\n' + loop)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.stdout.write(run_runbook(argv[0], argv[1], device=device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
