"""Unified multi-dataset loader, the port's copy of
``neural_spectral_codec_tpu/data/multi_dataset.py``: a cumulative-length
index space, searchsorted dispatch, and a config factory with
train/val/test splits. ``helipr`` is a first-class dataset type, as in
the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np

from neural_spectral_codec_torch.data.kitti import KITTILoader
from neural_spectral_codec_torch.data.nclt import NCLTLoader
from neural_spectral_codec_torch.data.helipr import HeLiPRLoader
from neural_spectral_codec_torch.data.synthetic import SyntheticLoader


def _make_loader(ds_type: str, root: str, seq: str, lazy_load: bool):
    if ds_type == "kitti":
        return KITTILoader(root, seq, lazy_load=lazy_load)
    if ds_type == "nclt":
        return NCLTLoader(root, seq, lazy_load=lazy_load)
    if ds_type == "helipr":
        return HeLiPRLoader(f"{root}/{seq}", lazy_load=lazy_load)
    if ds_type == "synthetic":
        return SyntheticLoader(seed=int(seq))
    raise ValueError(f"Unknown dataset type: {ds_type}")


class MultiDatasetLoader:
    """Concatenates per-sequence loaders behind one index space."""

    def __init__(self, datasets: List[dict], lazy_load: bool = True):
        self.datasets = []
        self.dataset_info = []
        cum = [0]
        for ds in datasets:
            ds_type, root = ds["type"], ds.get("root", "")
            weight = ds.get("weight", 1.0)
            for seq in ds["sequences"]:
                loader = _make_loader(ds_type, root, str(seq), lazy_load)
                self.datasets.append(loader)
                self.dataset_info.append(
                    {"type": ds_type, "sequence": str(seq), "weight": weight}
                )
                cum.append(cum[-1] + len(loader))
        self.cumulative_lengths = np.asarray(cum)
        self.total_length = int(cum[-1])
        if self.total_length == 0:
            raise ValueError("No data loaded! Check dataset configurations.")

    def _get_dataset_and_index(self, idx: int):
        if idx < 0 or idx >= self.total_length:
            raise IndexError(f"Index {idx} out of range [0, {self.total_length})")
        d = int(np.searchsorted(self.cumulative_lengths, idx, side="right") - 1)
        return d, idx - int(self.cumulative_lengths[d])

    def __len__(self) -> int:
        return self.total_length

    def __getitem__(self, idx: int) -> dict:
        d, local = self._get_dataset_and_index(idx)
        data = self.datasets[d][local]
        data["global_idx"] = idx
        data["dataset_idx"] = d
        data["dataset_type"] = self.dataset_info[d]["type"]
        return data

    # --- introspection ---

    def get_dataset_info(self, dataset_idx: int) -> dict:
        return self.dataset_info[dataset_idx]

    def get_all_info(self) -> List[dict]:
        return self.dataset_info

    def sequence_id_of(self, idx: int) -> int:
        """Sequence index owning global frame ``idx`` (used for per-sequence
        triplet mining)."""
        return self._get_dataset_and_index(idx)[0]

    def get_frames_by_dataset(self, dataset_type: str) -> List[int]:
        out = []
        for i, info in enumerate(self.dataset_info):
            if info["type"] == dataset_type:
                out.extend(range(int(self.cumulative_lengths[i]),
                                 int(self.cumulative_lengths[i + 1])))
        return out

    def split_by_dataset(self) -> Dict[str, List[int]]:
        splits: Dict[str, List[int]] = {}
        for i, info in enumerate(self.dataset_info):
            splits.setdefault(info["type"], []).extend(
                range(int(self.cumulative_lengths[i]),
                      int(self.cumulative_lengths[i + 1]))
            )
        return splits


def create_multi_dataset_loader(
    config: dict, mode: str = "train"
) -> Union[MultiDatasetLoader, KITTILoader]:
    """Config factory (JAX multi_dataset.py:104)."""
    data_config = config["data"]
    if "datasets" in data_config:
        datasets = data_config["datasets"].get(mode, [])
        if not datasets:
            raise ValueError(f"No datasets configured for mode '{mode}'")
        return MultiDatasetLoader(datasets, lazy_load=data_config.get("lazy_load", True))

    root = data_config["kitti_root"]
    key = {"train": "sequences_train", "val": "sequences_val"}.get(mode, "sequences_test")
    sequences = [f"{i:02d}" for i in data_config[key]]
    if len(sequences) == 1:
        return KITTILoader(root, sequences[0], lazy_load=data_config.get("lazy_load", True))
    return MultiDatasetLoader(
        [{"type": "kitti", "root": root, "sequences": sequences, "weight": 1.0}],
        lazy_load=data_config.get("lazy_load", True),
    )
