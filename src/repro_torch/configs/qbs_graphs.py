"""Paper-dataset graph scales (Table 1) as dry-run stand-ins for the QbS
engine.  V/E are the undirected counts; the engine stores 2|E| directed
slots.  These drive ShapeDtypeStruct-only lowering of the distributed
labelling and serving steps at true paper scale."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GraphScale:
    name: str
    n_vertices: int
    n_edges_undirected: int   # |E^un| from Table 1
    n_landmarks: int = 20

    @property
    def n_edge_slots(self) -> int:
        return 2 * self.n_edges_undirected


GRAPHS = {
    g.name: g
    for g in [
        GraphScale("douban", 200_000, 300_000),
        GraphScale("youtube", 1_100_000, 3_000_000),
        GraphScale("skitter", 1_700_000, 11_100_000),
        GraphScale("livejournal", 4_800_000, 43_100_000),
        GraphScale("orkut", 3_100_000, 117_000_000),
        GraphScale("twitter", 41_700_000, 1_200_000_000),
        GraphScale("friendster", 65_600_000, 1_800_000_000),
        GraphScale("uk2007", 106_000_000, 3_300_000_000),
        GraphScale("clueweb09", 1_700_000_000, 7_800_000_000),
    ]
}
