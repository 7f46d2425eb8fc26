"""Rule families. Importing this package registers every rule in
trlx_tpu_torch.analysis.RULES."""

from trlx_tpu_torch.analysis.rules import (  # noqa: F401  (register on import)
    concurrency,
    contracts,
    locks,
    style,
    torch_hazards,
)
