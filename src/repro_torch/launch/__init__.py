"""Command-line entry points of the port, the twins of ``repro.launch``:

* ``serve``: build a labelling and answer SPG queries, on one device or
  vertex-sharded over a mesh (``--shards N``), directly or through
  streaming replicas (``--replicas N``) with a Prometheus scrape endpoint
  (``--metrics-port P``);
* ``train``: the LM training loop with checkpoints and resume;
* ``dryrun``: the production-mesh dry run, every LM and QbS cell laid out
  on the (16, 16) and (2, 16, 16) meshes and traced on the meta device
  (with ``mesh``, the production meshes, and ``hlo_stats``, the cost
  counter)."""
