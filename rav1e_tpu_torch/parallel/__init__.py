"""Multi-device parallelism (the port of rav1e_tpu/parallel).

Axes, as the reference's:
- 'gop': GOP data-parallelism across devices and processes
  (gop_encode.py: GopScheduler, DistributedGopScheduler);
- 'tile': AV1 tile columns as shards (tiles.py: ShardGroup, the
  reference's shard_map; tile_encode.py: encode_pframe_tiled), with the
  in-loop filters' halos exchanged between neighbours.
Devices are torch devices; two shards or workers may share one card.
"""
