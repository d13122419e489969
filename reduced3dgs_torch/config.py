"""Config — counterpart of reduced3dgs_tpu/config.py.

Field names, shorthand flags and defaults match the reference arguments,
so model directories written by training (their ``cfg_args`` file in the
``Namespace(...)`` repr format, ``dump_cfg_args``) load here unchanged;
``get_combined_args`` merges that file with CLI overrides.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import sys
from argparse import ArgumentParser, Namespace
from dataclasses import dataclass, field, fields


def _add_group(parser: ArgumentParser, cls, name: str, fill_none: bool = False):
    group = parser.add_argument_group(name)
    for f in fields(cls):
        shorthand = f.metadata.get("short")
        default = None if fill_none else f.default
        names = [f"--{f.name}"] + ([f"-{shorthand}"] if shorthand else [])
        if f.type in ("bool", bool):
            group.add_argument(*names, default=default, action="store_true")
        else:
            typ = type(f.default) if f.default is not None else str
            group.add_argument(*names, type=typ, default=default)


def _extract(cls, args: Namespace):
    kw = {}
    for f in fields(cls):
        v = getattr(args, f.name, None)
        kw[f.name] = f.default if v is None else v
    return cls(**kw)


@dataclass(frozen=True)
class ModelParams:
    sh_degree: int = 3
    source_path: str = field(default="", metadata={"short": "s"})
    model_path: str = field(default="", metadata={"short": "m"})
    images: str = field(default="images", metadata={"short": "i"})
    resolution: int = field(default=-1, metadata={"short": "r"})
    white_background: bool = field(default=False, metadata={"short": "w"})
    data_device: str = "cuda"  # accepted for CLI parity; see --device
    eval: bool = False

    def post(self):
        return dataclasses.replace(
            self, source_path=os.path.abspath(self.source_path)
            if self.source_path else "")


@dataclass(frozen=True)
class PipelineParams:
    """convert_SHs_python / compute_cov3D_python / debug are accepted for
    CLI parity; ``backend`` picks the compositor: "tile" (kernels) or
    "ref" (the masked oracle).  ``fused_steps`` > 1 groups up to that many
    fusible iterations into one Trainer.step_group (a replayed CUDA graph
    of the train step on the card).  ``grad_reduce`` is the per-primitive
    gradient reduction: "bf16x2" (the training default, packed payload and
    the fast feature table) or "f32" (full precision, the parity mode)."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    backend: str = "tile"
    fused_steps: int = 1
    grad_reduce: str = "bf16x2"


@dataclass(frozen=True)
class OptimizationParams:
    """The reference OptimizationParams, with the JAX package's
    defaults."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False
    lambda_alpha_regul: float = 0.0
    mercy_points: bool = False
    lambda_mercy: float = 1.0
    box_size: float = 1.0
    lambda_sh_sparsity: float = 0.0
    prune_dead_points: bool = False
    store_grads: bool = False
    mercy_interval: int = 10
    cdist_threshold: float = 0.0
    std_threshold: float = 0.0
    mercy_minimum: int = 3
    variable_sh_bands: bool = False
    mercy_type: str = "redundancy_opacity"


def add_model_params(parser, fill_none=False):
    _add_group(parser, ModelParams, "Loading Parameters", fill_none)


def add_pipeline_params(parser, fill_none=False):
    _add_group(parser, PipelineParams, "Pipeline Parameters", fill_none)


def add_optimization_params(parser, fill_none=False):
    _add_group(parser, OptimizationParams, "Optimization Parameters",
               fill_none)


def extract_optimization(args) -> OptimizationParams:
    return _extract(OptimizationParams, args)


def dump_cfg_args(model_path: str, args: Namespace):
    """Write the reference-format cfg_args file."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(str(Namespace(**vars(args))))


def extract_model(args) -> ModelParams:
    return _extract(ModelParams, args).post()


def extract_pipeline(args) -> PipelineParams:
    return _extract(PipelineParams, args)


def _parse_namespace(text: str) -> Namespace:
    """Parse a ``Namespace(k=v, ...)`` repr with literal values only."""
    call = ast.parse(text.strip(), mode="eval").body
    if not (isinstance(call, ast.Call) and isinstance(call.func, ast.Name)
            and call.func.id == "Namespace" and not call.args):
        raise ValueError(f"not a Namespace(...) repr: {text[:80]!r}")
    return Namespace(**{kw.arg: ast.literal_eval(kw.value)
                        for kw in call.keywords})


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """Merge CLI args with the model dir's stored cfg_args: the CLI wins
    where it is not None."""
    args_cmdline = parser.parse_args(sys.argv[1:] if argv is None else argv)
    cfgfile_string = "Namespace()"
    try:
        cfgfilepath = os.path.join(args_cmdline.model_path, "cfg_args")
        with open(cfgfilepath) as cfg_file:
            print(f"Config file found: {cfgfilepath}")
            cfgfile_string = cfg_file.read()
    except (TypeError, FileNotFoundError):
        pass
    merged = vars(_parse_namespace(cfgfile_string)).copy()
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)
