"""Typed configuration with reference-YAML compatibility.

The reference merges sectioned YAML (``common_args / data_args / model_args /
train_args / validation_args / device_args / comm_args / tracking_args``) flat
onto a duck-typed ``args`` namespace (``python/fedml/arguments.py:36-193``,
``Arguments.__init__``/``set_attr_from_config``), and everything downstream
does ``hasattr`` probing.  Here the same YAML vocabulary loads into one typed
frozen-ish dataclass (``Config``) with explicit defaults, so mistyped recipe
keys fail loudly instead of silently defaulting — while any reference
``fedml_config.yaml`` for a supported feature parses unchanged.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import yaml

from . import constants


@dataclass
class Config:
    # ---- common_args -------------------------------------------------------
    training_type: str = constants.TRAINING_PLATFORM_SIMULATION
    random_seed: int = 0
    federated_optimizer: str = constants.FEDERATED_OPTIMIZER_FEDAVG
    scenario: str = "horizontal"
    config_version: str = "release"
    run_id: str = "0"
    using_mlops: bool = False

    # ---- data_args ---------------------------------------------------------
    dataset: str = "cifar10"
    data_cache_dir: str = "~/fedml_data"
    partition_method: str = "hetero"  # homo | hetero | hetero-fix
    partition_alpha: float = 0.5
    # TPU-native additions
    synthetic_fallback: bool = True  # generate deterministic data if files absent
    synthetic_train_size: int = 0  # 0 -> dataset default
    synthetic_test_size: int = 0

    # ---- model_args --------------------------------------------------------
    model: str = "resnet20"
    model_file_cache_folder: str = ""
    global_model_file_path: str = ""
    norm: str = "batch"  # batch | group (resnet_gn escape hatch, SURVEY §7.3)

    # ---- train_args --------------------------------------------------------
    client_num_in_total: int = 10
    client_num_per_round: int = 5
    comm_round: int = 10
    epochs: int = 1
    batch_size: int = 32
    client_optimizer: str = "sgd"
    learning_rate: float = 0.03
    momentum: float = 0.0
    weight_decay: float = 0.0
    server_optimizer: str = "sgd"  # for FedOpt / FedAvgM
    server_lr: float = 1.0
    server_momentum: float = 0.0
    # algorithm-specific knobs
    fedprox_mu: float = 0.1
    feddyn_alpha: float = 0.01
    fednova_tau_eff: str = "uniform"
    mime_momentum: float = 0.9
    async_staleness_alpha: float = 0.5  # mixing weight for Async_FedAvg
    async_staleness_func: str = "polynomial"  # constant | polynomial | hinge
    group_num: int = 1  # HierarchicalFL groups
    group_comm_round: int = 1  # sub-rounds per group before global agg
    # compression (FedSGD path, reference utils/compression.py)
    compression: str = "no"  # no | topk | eftopk | quantize | qsgd
    compression_ratio: float = 0.01
    quantize_level: int = 8
    is_biased: bool = False

    # ---- agg_args (fork research: MyAvg CKA layer-selective aggregation,
    # reference my_research/.../fedml_config_7_m5top3_opt.yaml agg_args) ----
    agg_unselect_layer: tuple = ()
    agg_all_select_layer: tuple = ()
    agg_any_select_layer: tuple = ()
    agg_mod_list: tuple = ()
    agg_mod_dict: dict = field(default_factory=dict)
    cka_select_topk: int = 3
    cka_unselect_layer: tuple = ()
    cka_all_select_layer: tuple = ()
    cka_any_select_layer: tuple = ()
    cka_low_thresh: float = 0.0
    cka_high_thresh: float = 1.0

    # ---- validation_args ---------------------------------------------------
    frequency_of_the_test: int = 5
    test_batch_size: int = 0  # 0 -> batch_size

    # ---- device_args -------------------------------------------------------
    using_gpu: bool = True  # kept for YAML parity; means "use accelerator"
    device_type: str = "tpu"
    mesh_shape: str = ""  # e.g. "clients:8" or "silo:2,data:4"; "" -> auto
    backend_sim: str = constants.SIMULATION_BACKEND_MESH  # sp | MESH
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"  # MXU-friendly local-train compute
    step_mode: str = "match"  # match reference per-client step counts | fixed

    # ---- comm_args ---------------------------------------------------------
    backend: str = constants.SIMULATION_BACKEND_MESH
    mqtt_config_path: str = ""
    s3_config_path: str = ""
    grpc_ipconfig_path: str = ""
    trpc_master_config_path: str = ""

    # ---- tracking_args -----------------------------------------------------
    log_file_dir: str = "./log"
    enable_wandb: bool = False
    metrics_jsonl_path: str = ""  # TPU-native: jsonl metrics sink
    enable_tracking: bool = True

    # ---- attack/defense/dp/secagg (reference security yaml sections) -------
    enable_attack: bool = False
    attack_type: str = ""
    attack_client_num: int = 0
    poisoned_client_list: tuple = ()
    enable_defense: bool = False
    defense_type: str = ""
    byzantine_client_num: int = 0
    krum_param_m: int = 1
    norm_bound: float = 5.0
    trimmed_mean_beta: float = 0.1
    outlier_detection_k: float = 3.0
    enable_dp: bool = False
    mechanism_type: str = "gaussian"  # gaussian | laplace
    dp_solution_type: str = "ldp"  # ldp | cdp | nbafl
    epsilon: float = 1.0
    delta: float = 1e-5
    sensitivity: float = 1.0
    clipping_norm: float = 1.0
    enable_secagg: bool = False
    secagg_prime_bits: int = 31
    secagg_quant_bits: int = 16
    enable_fhe: bool = False
    enable_contribution: bool = False
    contribution_method: str = "gtg_shapley"  # gtg_shapley | leave_one_out

    # ---- cross-silo / distributed ------------------------------------------
    rank: int = 0
    role: str = "server"
    worker_num: int = 0
    n_node_in_silo: int = 1
    n_proc_per_node: int = 1
    process_id: int = 0

    # ---- checkpoint (TPU-native first-class, SURVEY §5) --------------------
    checkpoint_dir: str = ""
    checkpoint_every_rounds: int = 0  # 0 -> disabled
    resume: bool = False

    # escape hatch for unknown/extra recipe keys (kept, warned once)
    extra: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.test_batch_size == 0:
            self.test_batch_size = self.batch_size
        if isinstance(self.poisoned_client_list, list):
            self.poisoned_client_list = tuple(self.poisoned_client_list)
        for name in ("agg_unselect_layer", "agg_all_select_layer", "agg_any_select_layer",
                     "agg_mod_list", "cka_unselect_layer", "cka_all_select_layer",
                     "cka_any_select_layer"):
            v = getattr(self, name)
            if isinstance(v, list):
                object.__setattr__(self, name, tuple(v))

    # reference code reads duck-typed attributes; keep that working for extras
    def __getattr__(self, name: str) -> Any:  # graftlint: disable=GL001(the dynamic extra fallback cfg_extra builds on)
        extra = object.__getattribute__(self, "__dict__").get("extra", {})
        if name in extra:
            return extra[name]
        raise AttributeError(name)


_FIELD_NAMES = {f.name for f in dataclasses.fields(Config)}

# Reference key -> Config key renames (kept minimal; most names match).
_ALIASES = {
    "client_id_list": None,  # synthesized, ignored
    "using_gpu": "using_gpu",
    "gpu_id": None,
    "gpu_mapping_file": None,
    "gpu_mapping_key": None,
    "worker_num": "worker_num",
    "wandb_key": None,
    "wandb_project": None,
    "wandb_name": None,
}


def load_yaml_config(path: str) -> dict:
    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


def config_from_sections(sections: dict) -> Config:
    """Flatten reference-style sectioned YAML into a Config."""
    flat: dict[str, Any] = {}
    for section, kv in sections.items():
        if not isinstance(kv, dict):
            flat[section] = kv
            continue
        for k, v in kv.items():
            flat[k] = v
    kwargs: dict[str, Any] = {}
    extra: dict[str, Any] = {}
    for k, v in flat.items():
        if k in _ALIASES and _ALIASES[k] is None:
            continue
        k = _ALIASES.get(k, k)
        if k == "extra" and isinstance(v, dict):
            # a literal `extra:` block in any section holds free-form knobs —
            # MERGE its contents (the old behavior nested it as
            # cfg.extra['extra'], silently disabling every documented knob)
            extra.update(v)
        elif k in _FIELD_NAMES and k != "extra":
            kwargs[k] = v
        else:
            extra[k] = v
    cfg = Config(**kwargs, extra=extra)
    return cfg


def add_args(argv: Optional[list[str]] = None) -> Config:
    """CLI entry mirroring reference ``add_args`` (``arguments.py:36``):
    ``--cf`` YAML config file, ``--rank``, ``--role``, ``--run_id`` overrides."""
    parser = argparse.ArgumentParser(prog="fedml_tpu_torch")
    parser.add_argument("--cf", "--config_file", dest="cf", type=str, default=None)
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--role", type=str, default=None)
    parser.add_argument("--run_id", type=str, default=None)
    parser.add_argument("--run_device_id", type=str, default=None)
    ns, _unknown = parser.parse_known_args(argv)
    sections = load_yaml_config(ns.cf) if ns.cf else {}
    cfg = config_from_sections(sections)
    for k in ("rank", "role", "run_id"):
        v = getattr(ns, k)
        if v is not None:
            setattr(cfg, k, v)
    return cfg


def load_arguments(argv: Optional[list[str]] = None) -> Config:
    """Alias matching the reference entrypoint name (``arguments.py:193``)."""
    return add_args(argv)
