"""Config composition and instantiation for the PyTorch port.

The same user-facing surface as ``neddf_tpu/config.py`` (Hydra-style
``compose``, ``instantiate``, ``save_snapshot`` and ``load_snapshot``),
with two changes:

* YAML is read and written by ``utils/yaml_subset.py``, so no PyYAML is
  needed.
* ``_target_`` paths are remapped onto this package: ``neddf_tpu.*``
  (this repo's snapshots, e.g. ``pretrained/machine_neddf/.hydra``) and
  the upstream reference's ``neddf.*`` both resolve to
  ``neddf_tpu_torch.*``.
"""
from __future__ import annotations

import importlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from neddf_tpu_torch.utils import yaml_subset

_PACKAGE = "neddf_tpu_torch"

# upstream reference `_target_` paths (neddf.*) -> this package
_REFERENCE_ALIASES: Dict[str, str] = {
    "neddf.dataset.NeRFSyntheticDataset": "data.NeRFSyntheticDataset",
    "neddf.network.NeDDF": "fields.NeDDF",
    "neddf.network.NeRF": "fields.NeRF",
    "neddf.network.NeuS": "fields.NeuS",
    "neddf.render.NeRFRender": "render.NeRFRender",
    "neddf.trainer.NeRFTrainer": "training.NeRFTrainer",
    "neddf.loss.ColorLoss": "training.ColorLoss",
    "neddf.loss.MaskBCELoss": "training.MaskBCELoss",
    "neddf.loss.MaskMSELoss": "training.MaskMSELoss",
    "neddf.loss.FieldsConstraintLoss": "training.FieldsConstraintLoss",
}

ConfigDict = Dict[str, Any]


def remap_target(target: str) -> str:
    """Map a snapshot's ``_target_`` onto ``neddf_tpu_torch``."""
    if target in _REFERENCE_ALIASES:
        return f"{_PACKAGE}.{_REFERENCE_ALIASES[target]}"
    if target.startswith("neddf_tpu."):
        return _PACKAGE + target[len("neddf_tpu") :]
    return target


def _set_dotted(cfg: ConfigDict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def compose_override(cfg: ConfigDict, dotted: str, value: str) -> None:
    """Set the leaf ``dotted`` of a composed config to the scalar that
    ``value`` reads as (an override ``a.b=value``)."""
    _set_dotted(cfg, dotted, yaml_subset.parse_scalar(value))


def compose(
    config_dir: Union[str, Path],
    config_name: str = "config",
    overrides: Optional[List[str]] = None,
) -> ConfigDict:
    """Compose a config like ``neddf_tpu.config.compose``.

    ``defaults`` entries ``- group: name`` pull in ``group/name.yaml``;
    overrides ``group=name`` swap a group file and ``a.b=value`` set a
    leaf. A root file without ``defaults`` (a ``.hydra`` snapshot) is
    taken as already composed.
    """
    config_dir = Path(config_dir)
    overrides = list(overrides or [])
    root = yaml_subset.load(config_dir / f"{config_name}.yaml") or {}

    cfg: ConfigDict = {}
    if "defaults" in root:
        group_choice: Dict[str, str] = {}
        for entry in root.pop("defaults"):
            if isinstance(entry, dict):
                for group, name in entry.items():
                    group_choice[str(group)] = str(name)
            elif entry != "_self_":
                raise ValueError(f"unsupported defaults entry: {entry!r}")
        for ov in overrides:
            key, _, val = ov.partition("=")
            if "." not in key and key in group_choice:
                group_choice[key] = val
        for group, name in group_choice.items():
            cfg[group] = yaml_subset.load(config_dir / group / f"{name}.yaml")
        cfg.update(root)
    else:
        cfg = root

    for ov in overrides:
        key, _, val = ov.partition("=")
        if "." in key or key not in cfg or not isinstance(cfg.get(key), dict):
            _set_dotted(cfg, key, yaml_subset.parse_scalar(val))
    return cfg


def resolve_target(target: str) -> Any:
    """Import the object named by a (remapped) dotted ``_target_`` path."""
    module_name, _, attr = remap_target(target).rpartition(".")
    return getattr(importlib.import_module(module_name), attr)


def instantiate(node: ConfigDict, **extra: Any) -> Any:
    """Call the node's ``_target_`` with its other keys (non-recursive)."""
    if "_target_" not in node:
        raise ValueError(f"node has no _target_: {list(node)}")
    kwargs = {k: v for k, v in node.items() if not k.startswith("_")}
    kwargs.update(extra)
    return resolve_target(node["_target_"])(**kwargs)


def save_snapshot(cfg: ConfigDict, overrides: List[str], run_dir: Union[str, Path]) -> None:
    """Write ``.hydra/{config,overrides}.yaml`` into the run directory
    (``neddf_tpu/config.py::save_snapshot``); targets stay as composed,
    so both packages recompose the snapshot."""
    hydra_dir = Path(run_dir) / ".hydra"
    hydra_dir.mkdir(parents=True, exist_ok=True)
    (hydra_dir / "config.yaml").write_text(yaml_subset.dumps(cfg))
    (hydra_dir / "overrides.yaml").write_text(yaml_subset.dumps(list(overrides)))


def load_snapshot(run_dir: Union[str, Path]) -> ConfigDict:
    """Recompose the config saved in ``run_dir/.hydra``."""
    return compose(Path(run_dir) / ".hydra", "config")
