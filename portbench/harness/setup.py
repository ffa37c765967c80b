"""What both drivers do around the program: write a configuration's
files into the run's work directory, write generated rows, and run one
job of the program's command line in process."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
from pathlib import Path
from typing import Dict, List, Optional


def write_config_files(cfg: dict, work: Path,
                       placeholders: Optional[Dict[str, str]] = None
                       ) -> Dict[str, Path]:
    """Write every file of the configuration (``files``: a schema as a
    JSON object, a properties file as a flat object of strings) under
    ``work``.  A property whose value names another of the files becomes
    that file's path; a value in ``placeholders`` becomes its
    replacement.  Returns the path of each file by its name."""
    placeholders = placeholders or {}
    files = cfg["files"]
    paths = {name: work / "conf" / name for name in files}
    for name, body in files.items():
        p = paths[name]
        p.parent.mkdir(parents=True, exist_ok=True)
        if name.endswith(".json"):
            p.write_text(json.dumps(body))
            continue
        lines = []
        for k, v in body.items():
            v = str(paths[v]) if v in paths else placeholders.get(v, v)
            lines.append(f"{k}={v}")
        p.write_text("\n".join(lines) + "\n")
    return paths


def write_rows(path: Path, data: bytes) -> Path:
    """One input part file under the directory ``path``."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "part-00000").write_bytes(data)
    return path


def run_job(job: str, props: Path, in_dir: Path, out_dir: Path,
            device: str, defines: Optional[Dict[str, str]] = None) -> str:
    """One job through ``avenir_tpu_torch.cli.main``, in process, with
    its counters (standard error) captured and returned."""
    from avenir_tpu_torch.cli import main as cli_main

    if out_dir.exists():
        shutil.rmtree(out_dir)
    argv = [job, f"-Dconf.path={props}"]
    argv += [f"-D{k}={v}" for k, v in (defines or {}).items()]
    argv += [str(in_dir), str(out_dir), "--device", device]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    if rc != 0:
        raise RuntimeError(f"job {job} exited {rc}: {err.getvalue()[-2000:]}")
    return err.getvalue()


def read_model(out_dir: Path) -> List[str]:
    return (out_dir / "part-r-00000").read_text().splitlines()
