"""Job configuration: the port's copy of ``avenir_tpu/core/config.py``.

Java-properties files passed as ``-Dconf.path=<file>.properties``, flat
lower-dot-case keys optionally namespaced by a job prefix with un-prefixed
fallback, required keys that fail fast, and ``-Dkey=value`` overrides on
the command line.  The same ``.properties`` files drive both packages.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class JobConfig:
    """Flat key/value config with job-prefix fallback lookup."""

    _MISSING = object()

    def __init__(self, props: Optional[Dict[str, str]] = None, prefix: str = ""):
        self.props: Dict[str, str] = dict(props or {})
        self.prefix = prefix

    def _raw(self, key: str):
        if self.prefix:
            v = self.props.get(f"{self.prefix}.{key}", self._MISSING)
            if v is not self._MISSING:
                return v
        return self.props.get(key, self._MISSING)

    def with_prefix(self, prefix: str) -> "JobConfig":
        return JobConfig(self.props, prefix)

    def set(self, key: str, value) -> None:
        self.props[key] = str(value)

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        v = self._raw(key)
        return default if v is self._MISSING else v

    def get_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        v = self._raw(key)
        return default if v is self._MISSING else int(v)

    def get_float(self, key: str,
                  default: Optional[float] = None) -> Optional[float]:
        v = self._raw(key)
        return default if v is self._MISSING else float(v)

    def get_boolean(self, key: str, default: bool = False) -> bool:
        v = self._raw(key)
        if v is self._MISSING:
            return default
        return str(v).strip().lower() == "true"

    def get_list(self, key: str, delim: str = ",",
                 default=None) -> Optional[List[str]]:
        v = self._raw(key)
        return default if v is self._MISSING else str(v).split(delim)

    def must(self, key: str, msg: Optional[str] = None) -> str:
        v = self._raw(key)
        if v is self._MISSING:
            raise KeyError(msg or f"missing required configuration parameter: {key}")
        return v

    def must_int(self, key: str, msg: Optional[str] = None) -> int:
        return int(self.must(key, msg))

    def must_float(self, key: str, msg: Optional[str] = None) -> float:
        return float(self.must(key, msg))

    def must_list(self, key: str, delim: str = ",",
                  msg: Optional[str] = None) -> List[str]:
        return self.must(key, msg).split(delim)

    def subkeys(self, prefix: str) -> Dict[str, str]:
        """Every key under ``prefix.``, with the prefix stripped (the
        ``multi.job.<id>.*`` overrides of a shared-scan manifest)."""
        p = prefix if prefix.endswith(".") else prefix + "."
        return {k[len(p):]: v for k, v in self.props.items()
                if k.startswith(p)}

    def field_delim_regex(self) -> str:
        return self.get("field.delim.regex", ",")

    def field_delim_out(self) -> str:
        return self.get("field.delim.out", self.get("field.delim", ","))

    # the chunked-ingest keys (core/pipeline.py): ``pipeline.chunk.rows``,
    # ``pipeline.device.budget.bytes`` and ``pipeline.prefetch.depth``
    def pipeline_chunk_rows(self, row_bytes: Optional[int] = None,
                            default: Optional[int] = None) -> Optional[int]:
        from .pipeline import chunk_rows_from_config
        return chunk_rows_from_config(self, row_bytes=row_bytes,
                                      default=default)

    def pipeline_prefetch_depth(self) -> int:
        from .pipeline import prefetch_depth_from_config
        return prefetch_depth_from_config(self)


def parse_properties(text: str) -> Dict[str, str]:
    """Parse Java .properties: ``k=v`` / ``k: v`` lines, #/! comments,
    trailing-backslash line continuation, latin escape subset."""
    props: Dict[str, str] = {}
    logical: List[str] = []
    pending = ""
    for raw in text.splitlines():
        # java.util.Properties strips leading whitespace of continuation lines
        line = pending + (raw.lstrip() if pending else raw)
        if line.rstrip().endswith("\\") and not line.rstrip().endswith("\\\\"):
            pending = line.rstrip()[:-1]
            continue
        pending = ""
        logical.append(line)
    if pending:
        logical.append(pending)

    for line in logical:
        s = line.strip()
        if not s or s[0] in "#!":
            continue
        # the first unescaped = or :, or whitespace, separates key and value
        sep_idx = -1
        for i, ch in enumerate(s):
            if ch in "=:" and (i == 0 or s[i - 1] != "\\"):
                sep_idx = i
                break
            if ch.isspace():
                sep_idx = i
                break
        if sep_idx <= 0:
            continue
        key = s[:sep_idx].strip().replace("\\=", "=").replace("\\:", ":")
        val = s[sep_idx + 1:].lstrip() if s[sep_idx] in "=:" else s[sep_idx:].lstrip()
        if val[:1] in "=:":
            val = val[1:].lstrip()
        props[key] = val
    return props


def parse_cli_args(argv: List[str]):
    """Split an argument vector into ``-Dkey=value`` definitions and
    positional in/out paths."""
    defines: Dict[str, str] = {}
    positional: List[str] = []
    for a in argv:
        if a.startswith("-D") and "=" in a:
            k, v = a[2:].split("=", 1)
            defines[k] = v
        else:
            positional.append(a)
    return defines, positional


def load_job_config(defines: Dict[str, str], prefix: str = "") -> JobConfig:
    """Load the ``conf.path`` properties file, then overlay every other
    ``-D`` definition."""
    props: Dict[str, str] = {}
    conf_path = defines.get("conf.path")
    if conf_path:
        with open(conf_path, "r") as fh:
            props.update(parse_properties(fh.read()))
    for k, v in defines.items():
        if k != "conf.path":
            props[k] = v
    return JobConfig(props, prefix)
