"""Name -> class lookup for trainers, pipelines and orchestrators (port
of trlx_tpu.utils.loading). The first lookup imports the built-in
implementations so their ``@register_*`` decorators run. The names
``JaxPPOTrainer`` and ``AcceleratePPOModel`` resolve to the port's PPO
trainer, so one YAML means the same thing to both packages."""


def get_model(name: str):
    """The trainer class registered under ``name``."""
    from trlx_tpu_torch.trainers import _TRAINERS, _load_builtins

    _load_builtins()
    key = name.lower()
    if key in _TRAINERS:
        return _TRAINERS[key]
    raise KeyError(f"Model/trainer '{name}' not registered; known: "
                   f"{sorted(_TRAINERS)}")


def get_pipeline(name: str):
    """The pipeline class registered under ``name``."""
    from trlx_tpu_torch.pipeline import _DATAPIPELINE, _load_builtins

    _load_builtins()
    key = name.lower()
    if key in _DATAPIPELINE:
        return _DATAPIPELINE[key]
    raise KeyError(f"Pipeline '{name}' not registered; known: "
                   f"{sorted(_DATAPIPELINE)}")


def get_orchestrator(name: str):
    """The orchestrator class registered under ``name``."""
    from trlx_tpu_torch.orchestrator import _ORCH, _load_builtins

    _load_builtins()
    key = name.lower()
    if key in _ORCH:
        return _ORCH[key]
    raise KeyError(f"Orchestrator '{name}' not registered; known: "
                   f"{sorted(_ORCH)}")
