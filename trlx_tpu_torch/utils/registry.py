"""String-keyed class registry machinery (copy of
trlx_tpu.utils.registry: ``make_register`` and ``BuiltinLoader``)."""

import importlib
from typing import Dict, Sequence


def make_register(registry: Dict[str, type]):
    """Build a decorator that registers a class under a lowercase name.

    Usable bare (``@register``) or with an explicit name
    (``@register("myname")``).
    """

    def register(name):
        def register_class(cls, key: str):
            registry[key.lower()] = cls
            return cls

        if isinstance(name, str):
            return lambda cls: register_class(cls, name)
        return register_class(name, name.__name__)

    return register


class BuiltinLoader:
    """Imports builtin implementation modules once, on first lookup; the
    loaded flag is set only after every import succeeded, so a failed
    import is retried (and re-raised) rather than cached as an empty
    registry."""

    def __init__(self, modules: Sequence[str]):
        self.modules = tuple(modules)
        self.loaded = False

    def __call__(self):
        if self.loaded:
            return
        for mod in self.modules:
            importlib.import_module(mod)
        self.loaded = True
