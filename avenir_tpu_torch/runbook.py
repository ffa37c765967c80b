"""Run a reference runbook through the port.

A runbook (``resource/<name>/run.sh`` or ``run.py``) drives the reference
package: ``python -m avenir_tpu <Job> ...``, ``python -m
avenir_tpu.datagen ...``, or in Python ``from avenir_tpu.cli import main
as job``, ``[sys.executable, "-m", "avenir_tpu", "serve", ...]`` and
other imports of the package.  :func:`port_runbook` copies the runbook's
directory (and each sibling directory its script names as
``../<name>/``) and rewrites those command lines (a line continued with
``\\`` included) and the imports of every Python file there (helpers,
and a script fed to Python from the shell) to the port's, adding
``--device <device>`` to every job but the device-free ``router`` and
``fleetobs`` when a device is given, and binding a job class a script
builds itself (``from avenir_tpu.models.bayesian import
BayesianDistribution``) to that device; :func:`run_runbook` runs the
copy (or an unchanged copy, for the reference) in a subprocess from its
own directory.  :func:`run_script` does the same for one Python script
(``resource/ci/router_smoke.py``).  Command line::

    python -m avenir_tpu_torch.runbook <runbook dir> <scratch dir> [--device cpu]
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from typing import Callable, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# `-m avenir_tpu <args>` as a command (not the datagen module), with the
# line's continuation backslash apart
_SHELL_JOB = re.compile(r"-m avenir_tpu (.*?)([ \t]*\\)?[ \t]*$", re.M)
# the same command as a Python argument list: "-m", "avenir_tpu", "<job>"
_ARGV_JOB = re.compile(r"""(["'])-m\1,\s*(["'])avenir_tpu\2,\s*(["'])(\w+)\3""")
# a job class a script imports to build itself, on one line
_MODEL_IMPORT = re.compile(r"^([ \t]*)from avenir_tpu\.models\.(\w+) import "
                           r"(\w+)([ \t]*#.*)?$", re.M)
# the entry points that move bytes and read feeds: no device to name
_DEVICE_FREE = ("router", "fleetobs")


def _device_flag(job: str, device: Optional[str]) -> str:
    return "" if not device or job in _DEVICE_FREE else f" --device {device}"


def _rewrite_imports(text: str) -> str:
    return re.sub(r"\b(from|import) avenir_tpu\.", r"\1 avenir_tpu_torch.",
                  text)


def _rewrite_shell(text: str, device: Optional[str]) -> str:
    text = text.replace("-m avenir_tpu.datagen",
                        "-m avenir_tpu_torch.datagen")
    text = _SHELL_JOB.sub(
        lambda m: f"-m avenir_tpu_torch {m.group(1)}"
                  f"{_device_flag(m.group(1).split()[0], device)}"
                  f"{m.group(2) or ''}", text)
    return _rewrite_imports(text)


def _rewrite_helper(text: str, device: Optional[str]) -> str:
    """A Python file of the runbook: its imports, its subprocesses'
    argument lists, the jobs it builds itself, and the command lines its
    text names."""
    def argv(m):
        q = m.group(1)
        flag = _device_flag(m.group(4), device)
        extra = f", {q}--device{q}, {q}{device}{q}" if flag else ""
        return f"{q}-m{q}, {q}avenir_tpu_torch{q}, {q}{m.group(4)}{q}{extra}"

    text = _ARGV_JOB.sub(argv, text)
    if device:
        text = _MODEL_IMPORT.sub(
            lambda m: f"{m.group(1)}from avenir_tpu_torch.models.{m.group(2)}"
                      f" import {m.group(3)} as _port_{m.group(3)}"
                      f"{m.group(4) or ''}\n{m.group(1)}{m.group(3)} = "
                      f"__import__('functools').partial(_port_{m.group(3)}, "
                      f"device={device!r})", text)
    text = re.sub(r"-m avenir_tpu(?![\w.])", "-m avenir_tpu_torch", text)
    return _rewrite_imports(text)


def _rewrite_python(text: str, device: Optional[str]) -> str:
    job = ("from avenir_tpu_torch.cli import main as _port_main\n\n\n"
           "def job(argv):\n"
           f"    return _port_main(list(argv) + {['--device', device]!r})\n"
           if device else
           "from avenir_tpu_torch.cli import main as job\n")
    text = text.replace("from avenir_tpu.cli import main as job\n", job)
    return _rewrite_helper(text, device)


def _leftover(path: str, text: str) -> None:
    left = re.findall(r"avenir_tpu(?!_torch)\b[^\n]*", text)
    if left:
        raise ValueError(f"{path}: reference invocations left after the "
                         f"rewrite: {left}")


def _edit_file(path: str, rewrite: Callable[[str], str]) -> None:
    with open(path) as fh:
        text = rewrite(fh.read())
    _leftover(path, text)
    with open(path, "w") as fh:
        fh.write(text)


def _copy_siblings(src: str, dst: str, text: str) -> None:
    """Copy each directory beside ``src`` that ``text`` names as
    ``../<name>/`` to the same place beside ``dst`` (a ``work/`` left
    there by an earlier run is not copied)."""
    parent = os.path.dirname(os.path.abspath(src))
    for name in sorted(set(re.findall(r"\.\./(\w+)/", text))):
        there = os.path.join(parent, name)
        here = os.path.join(os.path.dirname(os.path.abspath(dst)), name)
        if os.path.isdir(there) and not os.path.exists(here):
            shutil.copytree(there, here,
                            ignore=shutil.ignore_patterns("work"))


def port_runbook(src: str, dst: str, device: Optional[str] = None,
                 port: bool = True,
                 edit: Optional[Callable[[str], str]] = None) -> str:
    """Copy the runbook directory ``src`` to ``dst`` with its ``run.sh``
    or ``run.py`` rewritten to drive the port (``port=False`` keeps the
    reference's commands); ``edit`` is then applied to the script's text.
    A directory beside ``src`` that the script names (``../workload/``)
    is copied beside ``dst``.  Returns the script's path.  Raises when a
    reference invocation is left over after the port's rewrite.  A
    ``work/`` left in ``src`` by an earlier run is not copied."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("work"))
    if port:
        for name in sorted(os.listdir(dst)):
            if name.endswith(".py") and name != "run.py":
                _edit_file(os.path.join(dst, name),
                           lambda text: _rewrite_helper(text, device))
    for name, rewrite in (("run.sh", _rewrite_shell),
                          ("run.py", _rewrite_python)):
        path = os.path.join(dst, name)
        if not os.path.exists(path):
            continue
        with open(path) as fh:
            text = fh.read()
        _copy_siblings(src, dst, text)
        if port:
            text = rewrite(text, device)
            _leftover(path, text)
        if edit is not None:
            text = edit(text)
        with open(path, "w") as fh:
            fh.write(text)
        return path
    raise FileNotFoundError(f"{src} holds no run.sh or run.py")


def _run(cmd, timeout: float, env: Optional[dict], cwd: Optional[str] = None
         ) -> str:
    paths = [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]
    run_env = dict(os.environ, PYTHON=sys.executable,
                   PYTHONPATH=os.pathsep.join(paths))
    run_env.update(env or {})
    proc = subprocess.run(cmd, env=run_env, capture_output=True, text=True,
                          timeout=timeout, cwd=cwd)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[1:])} exited {proc.returncode}:\n"
                           f"{out[-4000:]}")
    return out


def run_runbook(src: str, dst: str, device: Optional[str] = None,
                port: bool = True, timeout: float = 900.0,
                env: Optional[dict] = None,
                edit: Optional[Callable[[str], str]] = None,
                args: Sequence[str] = ()) -> str:
    """Run the runbook ``src`` from a copy at ``dst`` with the script's
    ``args`` (``resource/workload/run.sh`` takes scenario names): the
    port's rewrite (``port=True``) or the reference's script, each with
    ``edit`` applied.  Returns its standard output and error; raises
    with their tail when it exits non-zero."""
    script = port_runbook(src, dst, device, port=port, edit=edit)
    cmd = (["bash", script] if script.endswith(".sh")
           else [sys.executable, script])
    return _run(cmd + list(args), timeout, env)


def run_script(src: str, dst: str, device: Optional[str] = None,
               port: bool = True, timeout: float = 900.0,
               env: Optional[dict] = None) -> str:
    """Run the Python script ``src`` (``resource/ci/router_smoke.py``)
    from a copy in the directory ``dst``, rewritten to drive the port
    (``port=False``: unchanged).  It runs from the repository's root, so
    the subprocesses it starts with ``PYTHONPATH`` set to the copy's
    parent find the package there.  Returns its standard output and
    error; raises with their tail when it exits non-zero."""
    os.makedirs(dst, exist_ok=True)
    path = os.path.join(dst, os.path.basename(src))
    shutil.copyfile(src, path)
    if port:
        _edit_file(path, lambda text: _rewrite_helper(text, device))
    return _run([sys.executable, path], timeout, env, cwd=REPO)


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
