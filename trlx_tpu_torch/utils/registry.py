"""String-keyed class registry decorator (copy of trlx_tpu.utils.registry's
``make_register``)."""

from typing import Dict


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
