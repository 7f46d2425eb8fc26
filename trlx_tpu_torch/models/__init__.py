"""Model layer: functional transformer trunk, decode helpers, slot-pool
decode primitives and the weights carried across from trlx_tpu."""

from trlx_tpu_torch.models.transformer import ArchFlags  # noqa: F401
