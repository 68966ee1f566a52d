"""Gram geometry of the port (counterpart of kmerdb_tpu/ops/geom.py).

The TPU package sizes its K block and output tile for the v5e's matrix
unit and keeps a per-machine tile-rate table; none of that carries over.
The CUDA Gram (csrc/gram_pk_tri.cu) always computes 128 x 128 output
blocks and stages 128 patterns at a time, so here:

* ``kt`` only fixes the weight permutation (pk_weight_order) and the unit
  a pattern group is padded to.  It must be a multiple of 128; the
  smallest keeps the zero padding of each group smallest.
* ``tile`` is the edge of the coarse triangle: blocks whose coarse tile is
  strictly above the diagonal are skipped.  128, the block edge, skips the
  most work.
"""

#: weight bits per limb: (bit * w_l) stays an exact int8 product
LIMB_BITS = 7
#: K block of the weight permutation; a multiple of the kernel's 128-pattern stage
KT = 256
#: coarse triangle edge of the Gram; a multiple of PULL_TILE
TILE = 128
#: tile edge of the triangle pull (tril_tiles / untile_symmetric)
PULL_TILE = 128
