"""The port's fold certificate (``avenir_tpu_torch/core/algebra.py``) on
the CPU.

Every FoldSpec exporter of the port's job registry passes split
invariance, the carry merge and chunk-permutation invariance on the
one-position ``[cpu]`` mesh and on ``[cpu] * 8`` under the reference's
three seeds; the coverage closure finds no exporter without a workload;
the snapshot and histogram merges hold; a spec broken on purpose is shrunk
to a one-split reproducer.  The canned workload and the reports' shape are
held to the reference's, and each spec's whole-stream output to the
reference spec's on the reference's mesh.
"""

import numpy as np
import pytest
import torch

from avenir_tpu.core import algebra as jalg

from avenir_tpu_torch.core import algebra, multiscan
from avenir_tpu_torch.core.io import write_output
from avenir_tpu_torch.core.metrics import Counters
from avenir_tpu_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")
MESHES = {1: make_mesh([CPU]), 8: make_mesh([CPU] * 8)}
JIDS = ["nb", "mi", "corr", "het", "mst", "stats", "bandit_fb"]
ROWS = algebra.verification_rows()
CHECKS = ["split-invariance", "carry-merge", "chunk-permutation"]


@pytest.fixture(scope="module")
def work_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_algebra"))
    algebra.verification_jobs(d)        # writes the schema files once
    return d


def test_canned_workload_is_the_reference_s():
    assert ROWS == jalg.verification_rows()
    assert algebra.STATES == jalg.STATES


@pytest.mark.parametrize("n_pos", [1, 8])
@pytest.mark.parametrize("jid", JIDS)
def test_every_exporter_is_certified(work_dir, jid, n_pos):
    mesh = MESHES[n_pos]
    reps = algebra.verify_fold_spec(
        algebra.spec_factory(jid, work_dir, CPU), ROWS, mesh,
        seeds=algebra.DEFAULT_SEEDS, spec_name=jid)
    assert len(reps) == len(algebra.DEFAULT_SEEDS)
    for r in reps:
        assert r.withdrawn is None, r.format()
        assert not r.failed, r.format()
        assert [c.name for c in r.checks] == CHECKS
        assert r.splits, "no split points were exercised"
        assert r.mesh_desc == f"{n_pos}dev"


@pytest.mark.parametrize("jid", JIDS)
def test_whole_stream_output_is_the_reference_spec_s(work_dir, tmp_path,
                                                     mesh8, jid):
    """One segment through the port's spec and through the reference's:
    the same output lines."""
    seg = [("\n".join(ROWS) + "\n").encode()]
    got = algebra.run_spec_over_segments(
        algebra.spec_factory(jid, work_dir, CPU), seg, MESHES[8])
    jwd = str(tmp_path)
    jalg.verification_jobs(jwd)
    want = jalg.run_spec_over_segments(jalg.spec_factory(jid, jwd), seg,
                                       mesh8)
    assert got == want and got


def test_every_foldspec_exporter_has_verification_workload(tmp_path):
    """The coverage closure over the port's registry: all seven FoldSpec
    exporters of the reference, each with the reference's workload."""
    jobs = algebra.verification_jobs(str(tmp_path))
    covered = {cls for cls, _ in jobs.values()}
    exporters = set(algebra.registered_exporters())
    assert exporters <= covered, sorted(exporters - covered)
    assert exporters == {
        "BayesianDistribution", "MutualInformation", "CramerCorrelation",
        "HeterogeneityReductionCorrelation", "MarkovStateTransitionModel",
        "NumericalAttrStats", "BanditFeedbackAggregator"}
    ref = jalg.verification_jobs(str(tmp_path))
    assert jobs == ref


def test_bandit_fb_certificate_is_the_reference_s(work_dir, tmp_path,
                                                  mesh8):
    """The posterior fold's certificate on ``[cpu] * 8``: the same seeds,
    split points, checks and verdicts as the reference's on its 8-device
    mesh."""
    got = algebra.verify_fold_spec(
        algebra.spec_factory("bandit_fb", work_dir, CPU), ROWS, MESHES[8],
        seeds=algebra.DEFAULT_SEEDS, spec_name="bandit_fb")
    jwd = str(tmp_path)
    jalg.verification_jobs(jwd)
    want = jalg.verify_fold_spec(
        jalg.spec_factory("bandit_fb", jwd), jalg.verification_rows(), mesh8,
        seeds=jalg.DEFAULT_SEEDS, spec_name="bandit_fb")

    def shape(reps):
        return [{k: v for k, v in r.to_dict().items() if k != "mesh"}
                for r in reps]
    assert shape(got) == shape(want)
    assert not [r.format() for r in got if r.failed or r.withdrawn]


def test_run_dynamic_is_clean_on_the_cpu_meshes():
    for mesh in MESHES.values():
        reps = algebra.run_dynamic(seeds=(11,), mesh=mesh)
        assert len(reps) == len(JIDS) + 2
        assert not [r.format() for r in reps if r.failed or r.withdrawn]


@pytest.mark.parametrize("seed", algebra.DEFAULT_SEEDS)
def test_snapshot_merge_properties(seed):
    rep = algebra.verify_snapshot_merge(seed)
    assert not rep.failed, rep.format()
    assert [c.name for c in rep.checks] == [
        "merge == single-run", "commutativity", "associativity"]


@pytest.mark.parametrize("seed", algebra.DEFAULT_SEEDS)
def test_histogram_merge_properties(seed):
    rep = algebra.verify_histogram_merge(seed)
    assert not rep.failed, rep.format()
    assert [c.name for c in rep.checks] == [
        "merge == single-run", "commutativity", "state round-trip"]


class _ChunkCountingSpec(multiscan.FoldSpec):
    """Split-variant on purpose: finalize writes how many chunks it saw."""

    local_fn = None
    name = "chunk-counter"

    def __init__(self, out_path):
        self.out_path = out_path
        self.chunks = 0

    def encode(self, ctx):
        self.chunks += 1
        return ()

    def finalize(self, carry) -> Counters:
        write_output(self.out_path, [f"chunks={self.chunks}"])
        return Counters()


@pytest.mark.parametrize("n_pos", [1, 8])
def test_shrink_on_failure_names_spec_seed_and_splits(tmp_path, n_pos):
    rows = [f"id{i},v{i % 3}" for i in range(120)]
    out = str(tmp_path / "broken_out")
    rep = algebra.verify_fold_spec(
        lambda: _ChunkCountingSpec(out), rows, MESHES[n_pos], seeds=(7,),
        spec_name="chunk-counter")[0]
    assert rep.failed
    assert rep.shrunk is not None and len(rep.shrunk) == 1
    txt = rep.format()
    assert "chunk-counter" in txt and "seed=7" in txt
    assert str(rep.shrunk) in txt
    d = rep.to_dict()
    assert d["failed"] and d["spec"] == "chunk-counter"


def test_unsplittable_workload_is_reported_withdrawn(tmp_path):
    out = str(tmp_path / "tiny_out")
    rows = [f"id{i},v" for i in range(30)]    # < 2 * MIN_CHUNK_ROWS + 1
    reps = algebra.verify_fold_spec(
        lambda: _ChunkCountingSpec(out), rows, MESHES[1], seeds=(3,),
        spec_name="tiny")
    assert reps[0].withdrawn is not None
    assert "too few rows" in reps[0].withdrawn
    assert reps[0].checks == []


def test_merge_of_two_device_carries_is_the_whole_fold():
    """The psum claim at the carry level: two halves' MI dict carries,
    merged, equal the whole stream's carry."""
    from avenir_tpu_torch.core import pipeline
    from avenir_tpu_torch.models.mutual_info import _mi_local

    rng = np.random.default_rng(3)
    x = rng.integers(0, 6, (300, 3)).astype(np.int32)
    y = rng.integers(0, 2, 300).astype(np.int32)
    static = (2, 6, (0, 0, 1), (1, 2, 2))

    def fold(*chunks):
        cf = pipeline.ChunkFold(_mi_local, static_args=static,
                                mesh=MESHES[8])
        xfer = pipeline.ChunkTransfer(mesh=MESHES[8])
        for c in chunks:
            cf.fold(xfer(c))
        return cf.result()

    whole = fold((x, y))
    merged = multiscan.merge_carries(fold((x[:113], y[:113])),
                                     fold((x[113:], y[113:])))
    assert set(merged) == {"fc", "pc"}
    for k in merged:
        np.testing.assert_array_equal(merged[k], whole[k])
