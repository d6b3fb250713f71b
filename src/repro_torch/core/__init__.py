"""Query-by-Sketch core in PyTorch: the counterparts of ``repro.core``."""
from .distributed import ShardedLabels, distributed_build_sharded
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
    apply_edge_updates,
    barabasi_albert_graph,
    edge_keys,
    edge_set,
    from_edges,
    gnp_random_graph,
    grid_graph,
    largest_connected_component,
    random_regular_graph,
    resolve_device,
    ring_of_cliques,
    select_landmarks,
    to_networkx,
)
from .labelling import (
    LabellingScheme,
    affected_landmarks,
    build_labelling,
    labelling_size_bytes,
    meta_apsp,
    update_labelling,
)
from .mesh import Mesh, NamedMesh
from .packing import (
    PackedLabels,
    choose_pack_dtype,
    pack_bits,
    pack_dist,
    pack_labelling,
    packed_size_bytes,
    patch_packed,
    unpack_bits,
    widen_dist,
)
from .qbs import QbSIndex, SPGResult
from .sharded import ShardedIndex
from .search import Query, SearchContext, SearchResult, guided_search, make_search_context
from .sketch import SketchBatch, compute_sketch_batch, d_top_only

__all__ = [
    "INF", "Graph", "apply_edge_updates", "barabasi_albert_graph", "edge_keys",
    "edge_set", "from_edges",
    "gnp_random_graph", "grid_graph", "largest_connected_component",
    "random_regular_graph", "resolve_device", "ring_of_cliques",
    "select_landmarks", "to_networkx",
    "FrontierEngine", "HubSplit", "bfs_depths", "bfs_depths_batch",
    "hub_split", "make_relay", "segment_or",
    "LabellingScheme", "affected_landmarks", "build_labelling",
    "labelling_size_bytes", "meta_apsp", "update_labelling",
    "PackedLabels", "choose_pack_dtype", "pack_bits", "pack_dist",
    "pack_labelling", "packed_size_bytes", "patch_packed", "unpack_bits",
    "widen_dist",
    "QbSIndex", "SPGResult",
    "Mesh", "NamedMesh", "ShardedIndex", "ShardedLabels", "distributed_build_sharded",
    "Query", "SearchContext", "SearchResult", "guided_search",
    "make_search_context",
    "SketchBatch", "compute_sketch_batch", "d_top_only",
]
