"""Top-level YAML -> typed dataclass configuration.

JAX-free copy of trlx_tpu.data.configs: the same three-section layout
(model / train / method) and field names, so one YAML configures both
packages. ``yaml`` is imported only inside :meth:`TRLConfig.load_yaml`
(the card machine has no pyyaml; dict configs need none).
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional

from trlx_tpu_torch.data.method_configs import (
    MethodConfig,
    filter_known_fields,
    get_method,
)


@dataclass(frozen=True)
class ModelSpec:
    """Architecture hyperparameters for building a model from config."""

    arch: str = "gpt2"  # gpt2 | gptj | gptneox | llama
    vocab_size: int = 50257
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 0  # 0 => 4 * d_model
    n_positions: int = 1024
    rotary_dim: int = 0  # gptj/gptneox: rotary dims per head (0 => head_dim)
    layer_norm_epsilon: float = 1e-5
    tie_lm_head: bool = True  # gpt2 ties lm_head to wte; gptj/neox do not
    n_kv_heads: int = 0  # grouped-query attention (llama); 0 => n_head
    rope_theta: float = 10000.0

    def __post_init__(self):
        if self.d_ff == 0:
            object.__setattr__(self, "d_ff", 4 * self.d_model)
        if self.d_model % self.n_head != 0:
            raise ValueError("d_model must be divisible by n_head")
        if self.n_kv_heads and self.n_head % self.n_kv_heads != 0:
            raise ValueError("n_head must be divisible by n_kv_heads")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_head

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "ModelSpec":
        return cls(**filter_known_fields(cls, config))

    @classmethod
    def preset(cls, name: str) -> "ModelSpec":
        presets = {
            "gpt2": cls(arch="gpt2", n_layer=12, n_head=12, d_model=768),
            "gpt2-medium": cls(arch="gpt2", n_layer=24, n_head=16, d_model=1024),
            "gpt2-large": cls(arch="gpt2", n_layer=36, n_head=20, d_model=1280),
            "gpt2-xl": cls(arch="gpt2", n_layer=48, n_head=25, d_model=1600),
            "gpt-j-6b": cls(
                arch="gptj", vocab_size=50400, n_layer=28, n_head=16,
                d_model=4096, n_positions=2048, rotary_dim=64,
                tie_lm_head=False,
            ),
            "llama-2-7b": cls(
                arch="llama", vocab_size=32000, n_layer=32, n_head=32,
                d_model=4096, d_ff=11008, n_positions=4096,
                layer_norm_epsilon=1e-5, tie_lm_head=False,
            ),
            "llama-3-8b": cls(
                arch="llama", vocab_size=128256, n_layer=32, n_head=32,
                n_kv_heads=8, d_model=4096, d_ff=14336, n_positions=8192,
                rope_theta=500000.0, layer_norm_epsilon=1e-5,
                tie_lm_head=False,
            ),
        }
        key = name.lower()
        if key not in presets:
            raise KeyError(f"Unknown model preset '{name}'; known: {sorted(presets)}")
        return presets[key]


@dataclass
class ModelConfig:
    """Model section (field parity with trlx_tpu's ModelConfig)."""

    model_path: str
    tokenizer_path: str
    model_type: str
    device: str = ""
    num_layers_unfrozen: int = -1
    model_arch: str = "gpt2"
    model_spec: Optional[dict] = None
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    fused_attention: Optional[bool] = None

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**filter_known_fields(cls, config))

    def resolve_spec(self) -> "ModelSpec":
        """`model_spec` overrides, with `model_arch` supplying the arch
        unless the spec dict sets it explicitly."""
        overrides = dict(self.model_spec or {})
        overrides.setdefault("arch", self.model_arch)
        return ModelSpec.from_dict(overrides)


@dataclass
class TrainConfig:
    """Train section (field parity with trlx_tpu's TrainConfig; the
    trainers refuse, as trlx_tpu does, a ``mesh`` with both sp and pp
    above 1 — ``trlx_tpu_torch.trainers.check_ported``)."""

    n_ctx: int
    epochs: int
    total_steps: int
    batch_size: int
    grad_clip: float

    lr_ramp_steps: int
    lr_decay_steps: int
    weight_decay: float
    learning_rate_init: float
    learning_rate_target: float

    log_interval: int
    checkpoint_interval: int
    eval_interval: int

    pipeline: str
    orchestrator: str

    input_size: int = 0
    gen_size: int = 1024

    accelerate: bool = True
    accelerate_config_path: str = ""

    project_name: str = ""
    tracker: str = "print"

    mesh: Optional[Dict[str, int]] = None
    pp_num_microbatches: int = 4
    seed: int = 0
    remat: bool = False
    checkpoint_dir: str = "ckpts"
    resume_from: str = ""
    keep_checkpoints: int = 0
    max_bad_steps: int = 0
    max_step_kl: float = 0.0
    host_retries: int = 2
    host_retry_backoff: float = 0.5
    continuous_rollouts: bool = False
    optimizer: str = "adamw"
    adam_moment_dtype: str = "float32"
    save_on_preemption: bool = True
    preempt_poll_interval: int = 0
    stall_timeout: float = 0.0
    stall_first_timeout: float = 0.0
    stall_grace: float = 60.0
    stall_action: str = "checkpoint_exit"
    host_call_timeout: float = 0.0
    checkpoint_timeout: float = 0.0
    max_walltime: float = 0.0
    chaos: str = ""
    telemetry: bool = True
    telemetry_dir: str = ""
    telemetry_flush_every: int = 0
    debug_nans: bool = False

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return cls(**filter_known_fields(cls, config))


@dataclass
class TRLConfig:
    """Top-level config: model / train / method sections."""

    model: ModelConfig
    train: TrainConfig
    method: MethodConfig

    @classmethod
    def load_yaml(cls, yml_fp: str) -> "TRLConfig":
        import yaml  # only YAML files need pyyaml

        with open(yml_fp, mode="r") as f:
            config = yaml.safe_load(f)
        return cls.from_dict(config)

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "TRLConfig":
        return cls(
            ModelConfig.from_dict(config["model"]),
            TrainConfig.from_dict(config["train"]),
            get_method(config["method"]["name"]).from_dict(config["method"]),
        )

    def to_nested_dict(self) -> Dict[str, Any]:
        """Round-trippable three-section dict:
        ``from_dict(to_nested_dict())`` rebuilds an equivalent config."""
        return {
            "model": dict(self.model.__dict__),
            "train": dict(self.train.__dict__),
            "method": dict(self.method.__dict__),
        }
