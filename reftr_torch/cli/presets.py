"""Named presets: the model and input geometry of reftr_tpu/cli/presets.py.

A copy of the single-phrase REC detection presets (reftr_tpu/cli/presets.py
:14-18, :70-76 and their ``_101`` variants at :94-98), restricted to the
keys that shape the served model. Their training keys (dataset, splits,
epochs, learning-rate schedule) return with the training slice.
"""

from __future__ import annotations

from typing import Dict

from reftr_torch.core.config import DataConfig, ModelConfig, RefTRConfig

_REC = dict(num_feature_levels=1, dec_layers=6, aux_loss=True, img_size=640)

PRESETS: Dict[str, Dict] = {
    # configs/refcoco/RefTR_refcoco.sh stage 1 (REC detection)
    "refcoco_det": dict(_REC),
    # configs/refcoco+/RefTR_refcoco+.sh (REC detection)
    "refcoco_plus_det": dict(_REC, num_queries_per_phrase=1),
    # configs/refcocog/RefTR_refcocog.sh (umd split)
    "refcocog_det": dict(_REC),
    # configs/referit/RefTR_referit.sh
    "referit": dict(_REC),
}
for _name in list(PRESETS):
    PRESETS[f"{_name}_101"] = dict(PRESETS[_name], backbone="resnet101")

_DATA_KEYS = {"img_size", "max_query_len"}


def preset_config(name: str, **overrides) -> RefTRConfig:
    """The RefTRConfig of a preset; keyword overrides win, as explicit CLI
    flags win over a preset in reftr_tpu."""
    values = dict(PRESETS[name], **overrides)
    data = {k: values.pop(k) for k in list(values) if k in _DATA_KEYS}
    return RefTRConfig(model=ModelConfig(**values), data=DataConfig(**data))
