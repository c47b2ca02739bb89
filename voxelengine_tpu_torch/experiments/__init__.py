"""Measurement scripts of the port: counterparts of the repo's
``experiments/`` scripts that measure something the card has.

Each is a module run with ``python -m voxelengine_tpu_torch.experiments.
<name>``, on the card unless told otherwise, writing its numbers on stdout
and files only under ``experiments_out/`` (ignored by git):

- ``bench_frame_breakdown``: the bench frame split into ray setup, trace,
  and shading with the composite (``experiments/bench_frame_breakdown.py``);
- ``bench_shard_projection``: the N-card frame projected from each pixel
  shard's trace on one card (``experiments/bench_shard_projection.py``);
- ``verify_cyclic_1080p``: the block-cyclic frame at 1920x1080 on 8 ranks,
  byte for byte against one device (``experiments/verify_cyclic_1080p.py``);
- ``render_demo``: both checkerboard fields of a bench world as one 1080p
  PNG (``experiments/render_demo.py``).
"""
