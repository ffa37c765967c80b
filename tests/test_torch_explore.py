"""Queue 1 item 3's last host modules in the port, held against the JAX
package's: the in-memory suffix tree (``models/pst.py``'s
``SuffixTreeBuilder`` and ``SuffixTreeNode``), the PAC sample-size
calculator (``core/pac.py``), ``core/schema.py``'s ``CostSchema``, the
``disease``, ``xactions`` and ``numeric_classed`` presets with the
click-through reward simulator (``datagen``), the
``resource/disease_rules``, ``resource/marketing_plan`` and
``resource/multitenant`` runbooks through both packages from scratch
copies, every work file equal, and ``resource/multitenant``'s steps in
process beside the reference's, every response equal.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import pytest

from avenir_tpu.core import pac as jpac
from avenir_tpu.core.io import write_output as jax_write_output
from avenir_tpu.core.schema import CostSchema as JaxCostSchema
from avenir_tpu.datagen import cli as jcli
from avenir_tpu.datagen import ctr_reward_sampler as jax_ctr
from avenir_tpu.models.pst import SuffixTreeBuilder as JaxTreeBuilder

from avenir_tpu_torch import datagen
from avenir_tpu_torch.core import CostSchema, pac
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.io import write_output
from avenir_tpu_torch.models.pst import (ProbabilisticSuffixTreeGenerator,
                                         SuffixTreeBuilder, SuffixTreeNode)
from avenir_tpu_torch.runbook import REPO, run_runbook


def _tree_dict(node):
    return {"count": node.count,
            "children": {k: _tree_dict(v)
                         for k, v in sorted(node.children.items())}}


def test_suffix_tree_builder_on_the_generators_output(tmp_path):
    """``tests/test_explore.py:63``'s case through the port's generator
    and tree, then a partitioned tree, each equal to the reference's."""
    rows = [["x", "a", "b", "a", "b"], ["y", "b", "a", "b"]]
    write_output(str(tmp_path / "in"), [",".join(r) for r in rows])
    cfg = JobConfig({"skip.field.count": "1", "max.seq.length": "3"})
    ProbabilisticSuffixTreeGenerator(cfg, device="cpu").run(
        str(tmp_path / "in"), str(tmp_path / "out"))
    tree = SuffixTreeBuilder(str(tmp_path / "out"))
    assert tree.get_tree().find(["a", "b"]).count == 3
    assert tree.get_tree().find(["a", "b", "a"]).count == 1
    assert tree.get_tree().find(["z"]) is None
    ref = JaxTreeBuilder(str(tmp_path / "out"))
    assert _tree_dict(tree.get_tree()) == _tree_dict(ref.get_tree())

    lines = ["P1,a,b,4", "P1,b,2", "P2,a,a,1", "P2,a,b,3"]
    jax_write_output(str(tmp_path / "parts"), lines)
    mine = SuffixTreeBuilder(str(tmp_path / "parts"), num_id_fields=1)
    theirs = JaxTreeBuilder(str(tmp_path / "parts"), num_id_fields=1)
    assert sorted(mine.partitioned) == sorted(theirs.partitioned)
    for pid in mine.partitioned:
        assert _tree_dict(mine.get_tree(pid)) == _tree_dict(
            theirs.get_tree(pid))
    node = SuffixTreeNode()
    node.add(["q"], 2)
    assert node.find(["q"]).is_leaf() and not node.is_leaf()


@pytest.mark.parametrize("card", [(2, 3, 4), (3, 3, 2, 4), (5,)])
def test_pac_sample_sizes_equal_the_reference(card):
    classes = 2
    assert pac.terms_hyp_space(card, classes) == jpac.terms_hyp_space(
        card, classes)
    for c, d in ((1, 1), (1, 2), (len(card), 2)):
        assert pac.dnf_hyp_space(card, classes, c, d) == \
            jpac.dnf_hyp_space(card, classes, c, d)
    for d in range(1, len(card) + 1):
        assert pac.cnf_hyp_space_ln(card, classes, d) == \
            jpac.cnf_hyp_space_ln(card, classes, d)
    h = pac.terms_hyp_space(card, classes)
    assert pac.sample_sizes(h) == jpac.sample_sizes(h)
    assert pac.sample_sizes_ln(12.5, (0.1,), (0.05,)) == \
        jpac.sample_sizes_ln(12.5, (0.1,), (0.05,))


def test_cost_schema_equals_the_reference(tmp_path):
    path = tmp_path / "cost.json"
    path.write_text(json.dumps({"costAttributes": [
        {"name": "plan", "ordinal": 1, "cost": 2.5, "unit": "usd"},
        {"name": "network", "ordinal": 6, "cost": 0.75}]}))
    mine, ref = CostSchema.from_file(str(path)), JaxCostSchema.from_file(
        str(path))
    assert [vars(a) for a in mine.attributes] == [vars(a) for a in
                                                  ref.attributes]
    assert mine.cost_by_ordinal(6) == ref.cost_by_ordinal(6) == 0.75
    assert mine.attributes[0].extra == {"unit": "usd"}
    with pytest.raises(KeyError):
        mine.cost_by_ordinal(9)


@pytest.mark.parametrize("preset,sizes", [("disease", ("500",)),
                                          ("xactions", ("60", "45")),
                                          ("numeric_classed", ("400",))])
def test_presets_write_the_reference_bytes(tmp_path, preset, sizes):
    mine, ref = tmp_path / "mine.csv", tmp_path / "ref.csv"
    assert datagen.main([preset, *sizes, "--seed", "19", "--out",
                         str(mine)]) == 0
    assert jcli.main([preset, *sizes, "--seed", "19", "--out",
                      str(ref)]) == 0
    assert mine.read_bytes() == ref.read_bytes()
    assert datagen.main([preset, "--seed", "1"]) == 2


def test_ctr_reward_sampler_draws_the_reference_rewards():
    actions, sample = datagen.ctr_reward_sampler(seed=5)
    ref_actions, ref_sample = jax_ctr(seed=5)
    assert actions == ref_actions == ["page1", "page2", "page3"]
    seq = [actions[i % 3] for i in range(60)]
    assert [sample(a) for a in seq] == [ref_sample(a) for a in seq]


def _work_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".log"):       # a server's banner and timings
                continue
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("name", ["disease_rules", "marketing_plan",
                                  "multitenant"])
def test_item3_runbooks_through_the_port(tmp_path, name):
    """The runbook through the port (``--device cpu``) and through the
    reference, at once: both finish (the multitenant runbook with its own
    storm of 50 tenants x 8 rows at once and its assertions), and every
    work file but a server's log is equal."""
    src = os.path.join(REPO, "resource", name)

    def leg(args):
        tag, port, dev = args
        run_runbook(src, str(tmp_path / tag), device=dev, port=port,
                    timeout=600)
        return _work_files(str(tmp_path / tag / "work"))

    with ThreadPoolExecutor(2) as pool:
        mine, theirs = pool.map(leg, [("port", True, "cpu"),
                                      ("ref", False, None)])
    assert mine and mine == theirs


def test_multitenant_runbook_steps_through_the_port(tmp_path, monkeypatch):
    """``resource/multitenant/run.sh``'s steps in process: its data and
    the shared NB artifact (the reference's bytes), ``gen_tenants.py``'s
    1,000-tenant catalog, then a port server and a reference server over
    that catalog: a hot set and a cold tail of tenants, every response
    equal, the compile tier flat across same-schema tenants and the
    residency at the budget.  (The runbook itself checks only that each
    response has an output.)"""
    import runpy
    import sys

    from avenir_tpu.cli import main as jax_main
    from avenir_tpu.core.config import load_job_config as jax_load
    from avenir_tpu.serve import PredictionServer as JaxServer

    from avenir_tpu_torch.cli import main as port_main
    from avenir_tpu_torch.core.config import load_job_config
    from avenir_tpu_torch.serve import PredictionServer
    from avenir_tpu_torch.serve.server import request

    book = os.path.join(REPO, "resource", "multitenant")
    work = {}
    for tag, gen, main, dev in (("port", datagen.main, port_main, ["--device",
                                                                   "cpu"]),
                                ("ref", jcli.main, jax_main, [])):
        d = tmp_path / tag
        (d / "work" / "train").mkdir(parents=True)
        monkeypatch.chdir(d)
        for f in ("teleComChurn.json", "nb.properties", "bp.properties"):
            (d / f).write_bytes(open(os.path.join(book, f), "rb").read())
        assert gen(["telecom_churn", "3000", "--seed", "31", "--out",
                    "work/all.csv"]) == 0
        lines = open("work/all.csv").read().splitlines(keepends=True)
        open("work/train/part-00000", "w").write("".join(lines[:2400]))
        assert main(["BayesianDistribution", "-Dconf.path=nb.properties",
                     "work/train", "work/model"] + dev) == 0
        monkeypatch.setattr(sys, "argv", ["gen_tenants.py",
                                          "work/serve.properties", "1000",
                                          "50"])
        runpy.run_path(os.path.join(book, "gen_tenants.py"),
                       run_name="__main__")
        work[tag] = _work_files(str(d / "work"))
        work[tag + "_rows"] = [ln.strip() for ln in lines[2400:2410]]
    assert work["port"] == work["ref"]

    hot = [f"seg{i:04d}" for i in range(8)]
    tail = [f"seg{(97 * i) % 1000:04d}" for i in range(40, 46)]
    rows = work["port_rows"]
    answers = {}
    for tag, server, load, dev in (("port", PredictionServer, load_job_config,
                                    {"device": "cpu"}),
                                   ("ref", JaxServer, jax_load, {})):
        monkeypatch.chdir(tmp_path / tag)
        srv = server(load({"conf.path": "work/serve.properties"}), **dev)
        port = srv.start()
        try:
            def ask(name, row):
                r = request("127.0.0.1", port, {"model": name, "row": row})
                while r.get("cold_start") or r.get("quota_exceeded"):
                    r = request("127.0.0.1", port,
                                {"model": name, "row": row})
                r.pop("trace_id", None)
                return r

            got = [ask(hot[0], rows[0])]
            tier0 = request("127.0.0.1", port, {"cmd": "stats"})[
                "cache"]["compile_tier"]["compiles"]
            with ThreadPoolExecutor(len(hot)) as pool:
                got += list(pool.map(lambda n: [ask(n, r) for r in rows[:2]],
                                     hot))
            got += [ask(n, rows[3]) for n in tail]
            cache = request("127.0.0.1", port, {"cmd": "stats"})["cache"]
            assert cache["compile_tier"]["compiles"] == tier0
            assert cache["registered"] == 1000
            assert cache["resident"] <= 50
            answers[tag] = got
        finally:
            srv.stop()
    assert answers["port"] == answers["ref"]
    assert all("output" in r for r in answers["port"][len(hot) + 1:])
