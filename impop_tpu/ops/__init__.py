from impop_tpu.ops.panelquad import masked_pair_sums_xla

__all__ = ["masked_pair_sums_xla"]
