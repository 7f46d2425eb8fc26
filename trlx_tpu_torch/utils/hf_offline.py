"""Shared local-files-first loading policy for HF assets.

Offline environments (a build or test machine without network) must never
stall on hub retries: try the local cache/dir first, and only go to the
network when the environment hasn't opted out via HF_HUB_OFFLINE.
"""

import os
from typing import Iterator


def local_first_attempts() -> Iterator[dict]:
    """Yields kwargs dicts for from_pretrained-style calls: local first,
    then (if permitted) the network."""
    yield {"local_files_only": True}
    if not os.environ.get("HF_HUB_OFFLINE"):
        yield {"local_files_only": False}
