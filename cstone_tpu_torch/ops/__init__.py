"""Bit helpers, primitives and the hand-written stencil kernel
(counterpart of cstone_tpu/ops)."""
