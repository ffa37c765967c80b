"""The port's host substrate (copies of the reference's jax-free modules)
and the device half of the chunked ingest pipeline.  The package exports
the reference's ``avenir_tpu.core`` names, so a script's ``from
avenir_tpu.core import write_output`` reads the same against the port."""

from .schema import FeatureSchema, FeatureField, CostSchema  # noqa: F401
from .config import JobConfig, parse_properties, parse_cli_args, load_job_config  # noqa: F401
from .io import read_lines, read_records, split_line, write_output, OutputWriter  # noqa: F401
from .binning import DatasetEncoder, EncodedDataset, Vocab  # noqa: F401
from .metrics import Counters, ConfusionMatrix, CostBasedArbitrator  # noqa: F401
from .obs import LatencyHistogram, Metrics, Tracer, get_tracer, traced_run  # noqa: F401
