"""Query-by-Sketch core in PyTorch: the counterparts of ``repro.core``."""
from .frontier import (
    FrontierEngine,
    HubSplit,
    bfs_depths,
    bfs_depths_batch,
    hub_split,
    make_relay,
    segment_or,
)
from .graph import (
    INF,
    Graph,
    barabasi_albert_graph,
    edge_set,
    from_edges,
    gnp_random_graph,
    grid_graph,
    largest_connected_component,
    random_regular_graph,
    resolve_device,
    ring_of_cliques,
    select_landmarks,
)
from .labelling import LabellingScheme, build_labelling, labelling_size_bytes, meta_apsp
from .packing import (
    PackedLabels,
    choose_pack_dtype,
    pack_bits,
    pack_dist,
    pack_labelling,
    packed_size_bytes,
    unpack_bits,
    widen_dist,
)
from .qbs import QbSIndex, SPGResult
from .search import Query, SearchContext, SearchResult, guided_search, make_search_context
from .sketch import SketchBatch, compute_sketch_batch, d_top_only

__all__ = [
    "INF", "Graph", "barabasi_albert_graph", "edge_set", "from_edges",
    "gnp_random_graph", "grid_graph", "largest_connected_component",
    "random_regular_graph", "resolve_device", "ring_of_cliques",
    "select_landmarks",
    "FrontierEngine", "HubSplit", "bfs_depths", "bfs_depths_batch",
    "hub_split", "make_relay", "segment_or",
    "LabellingScheme", "build_labelling", "labelling_size_bytes", "meta_apsp",
    "PackedLabels", "choose_pack_dtype", "pack_bits", "pack_dist",
    "pack_labelling", "packed_size_bytes", "unpack_bits", "widen_dist",
    "QbSIndex", "SPGResult",
    "Query", "SearchContext", "SearchResult", "guided_search",
    "make_search_context",
    "SketchBatch", "compute_sketch_batch", "d_top_only",
]
