"""Greedy graph clustering: the port's copy of ``avenir_tpu/models/cluster.py``
(no device work; the distances come from the kNN distance job).

Greedy graph clustering (cluster/AgglomerativeGraphical.java,
cluster/EdgeWeightedCluster.java) plus the entity-distance random-access
store (util/EntityDistanceMapFileAccessor.java equivalent).

The reference keeps pairwise distances in a Hadoop ``MapFile`` for O(log n)
row lookups (EntityDistanceMapFileAccessor.java:70-127); here the store is a
host dict built from either row-format lines (``entity, other1, d1, other2,
d2, ...``) or the SameTypeSimilarity pair lines produced in-framework — the
distance matrix itself comes off the device (ops.distance), so the O(n^2)
work that sifarish did upstream stays on the card.

Greedy membership (AgglomerativeGraphical.GraphMapper.map,
AgglomerativeGraphical.java:96-117): for each entity in arrival order, try
every existing cluster, computing the average edge weight if the entity
joined (EdgeWeightedCluster.tryMembership, EdgeWeightedCluster.java:47-81:
``(avgWeight * numEdges + weightSum) / (numEdges + clusterSize)``, with
distances flipped to weights as ``distScale - d`` when the store holds
distances); join the best cluster if above ``min.av.edge.weight.threshold``,
else found a new cluster.

Parity notes (reference defects fixed as intended):
- the reference founds new clusters EMPTY (``clusters.add(new
  EdgeWeightedCluster())``, AgglomerativeGraphical.java:113 — the entity is
  dropped); we seed the new cluster with the entity.
- EntityDistanceMapFileAccessor.read splits the row by the delimiter and
  then splits each single token by the same delimiter again
  (EntityDistanceMapFileAccessor.java:115-121), which can never produce the
  (entity, distance) pairs it indexes; we parse alternating tokens.
- initReader assigns its MapFile.Reader to a local, leaving the field null
  (EntityDistanceMapFileAccessor.java:106-110); nothing to reproduce.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from ..core.config import JobConfig
from ..core.io import read_lines, split_line, write_output
from ..core.metrics import Counters
from ..core.obs import traced_run
from ..device import resolve_device


class EntityDistanceStore:
    """entity -> {other: distance} random-access map."""

    def __init__(self):
        self.rows: Dict[str, Dict[str, float]] = {}

    @classmethod
    def from_row_file(cls, path: str, delim_regex: str = ",") -> "EntityDistanceStore":
        """Row format: ``entity, other1, d1, other2, d2, ...`` (the MapFile
        value layout the reference writes,
        EntityDistanceMapFileAccessor.java:70-93)."""
        store = cls()
        for line in read_lines(path):
            items = split_line(line, delim_regex)
            row = store.rows.setdefault(items[0], {})
            for i in range(1, len(items) - 1, 2):
                row[items[i]] = float(items[i + 1])
        return store

    @classmethod
    def from_pair_file(cls, path: str, delim_regex: str = ",") -> "EntityDistanceStore":
        """Pair format: ``id1, id2, distance, ...`` (SameTypeSimilarity
        output); symmetrized."""
        store = cls()
        for line in read_lines(path):
            items = split_line(line, delim_regex)
            d = float(items[2])
            store.rows.setdefault(items[0], {})[items[1]] = d
            store.rows.setdefault(items[1], {})[items[0]] = d
        return store

    def read(self, entity: str) -> Dict[str, float]:
        return self.rows.get(entity, {})


class EdgeWeightedCluster:
    """cluster/EdgeWeightedCluster.java semantics."""

    def __init__(self, cluster_id: str, dist_scale: Optional[float] = None):
        self.id = cluster_id
        self.members: List[str] = []
        self.av_edge_weight = 0.0
        self.dist_scale = dist_scale   # set -> store holds distances

    def add(self, entity: str, av_edge_weight: float) -> None:
        self.members.append(entity)
        self.av_edge_weight = av_edge_weight

    def try_membership(self, entity: str, store: EntityDistanceStore) -> float:
        weight_sum = 0.0
        for member in self.members:
            d = store.read(member).get(entity)
            if d is not None:
                weight_sum += (self.dist_scale - d
                               if self.dist_scale is not None else d)
        n = len(self.members)
        num_edges = (n * (n - 1)) // 2
        return (self.av_edge_weight * num_edges + weight_sum) / (num_edges + n)

    def to_line(self, delim: str = ",") -> str:
        return delim.join([self.id] + self.members
                          + [str(self.av_edge_weight)])


class AgglomerativeGraphical:
    """Map-only greedy clustering job (cluster/AgglomerativeGraphical.java).

    Config: ``min.av.edge.weight.threshold`` (required),
    ``distance.file.path`` (row- or pair-format distance store; pair format
    auto-detected when ``distance.file.format=pair``), ``distance.scale``
    (set when the store holds distances rather than similarities)."""

    def __init__(self, config: JobConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.threshold = config.must_float(
            "min.av.edge.weight.threshold", "missing min average edge weight")
        self.rng = random.Random(config.get_int("seed", None))

    def _load_store(self) -> EntityDistanceStore:
        path = self.config.must("distance.file.path",
                                "missing distance map file directory")
        fmt = self.config.get("distance.file.format", "row")
        regex = self.config.field_delim_regex()
        if fmt == "pair":
            return EntityDistanceStore.from_pair_file(path, regex)
        return EntityDistanceStore.from_row_file(path, regex)

    def _new_id(self) -> str:
        return "%032x" % self.rng.getrandbits(128)

    @traced_run
    def run(self, in_path: str, out_path: str) -> Counters:
        counters = Counters()
        delim_regex = self.config.field_delim_regex()
        delim = self.config.field_delim_out()
        store = self._load_store()
        dist_scale = self.config.get_float("distance.scale", None)

        clusters: List[EdgeWeightedCluster] = []
        for line in read_lines(in_path):
            entity = split_line(line, delim_regex)[0]
            best = None
            best_weight = -float("inf")
            for cluster in clusters:
                w = cluster.try_membership(entity, store)
                if w > best_weight:
                    best_weight = w
                    best = cluster
            if best is not None and best_weight > self.threshold:
                best.add(entity, best_weight)
            else:
                fresh = EdgeWeightedCluster(self._new_id(), dist_scale)
                fresh.add(entity, 0.0)
                clusters.append(fresh)

        counters.set("Cluster", "clusters", len(clusters))
        write_output(out_path, (c.to_line(delim) for c in clusters))
        return counters
