"""File datasets (the port's copy of audiodec_tpu/data/dataset.py:
`find_files`, `load_files`, `SingleDataset`, `MultiDataset`): indexable
collections of float32 (T, C) numpy arrays, read with data/wav.py."""

from __future__ import annotations

import fnmatch
import os
from typing import List, Sequence

import numpy as np

from audiodec_tpu_torch.data.wav import read_wav, wav_info


def find_files(root_dir: str, query: str = "*.wav",
               include_root_dir: bool = True) -> List[str]:
    """Recursive glob, sorted."""
    files = []
    for root, _, filenames in os.walk(root_dir, followlinks=True):
        for filename in fnmatch.filter(filenames, query):
            files.append(os.path.join(root, filename))
    files = sorted(files)
    if not include_root_dir:
        files = [f.replace(root_dir + "/", "") for f in files]
    return files


def _load_list(files) -> List[str]:
    """A directory (globbed), a list file (one path a line) or a list."""
    if isinstance(files, (list, tuple)):
        return list(files)
    if os.path.isdir(files):
        return find_files(files)
    if os.path.isfile(files):
        with open(files) as f:
            return [line.strip() for line in f if line.strip()]
    raise ValueError(f"{files} is not a directory, list file, or list")


def load_files(data_path, query: str = "*.wav", num_core: int = 1):
    """File list, optionally split into num_core roughly equal chunks."""
    files = _load_list(data_path) if not os.path.isdir(data_path) \
        else find_files(data_path, query)
    if num_core <= 1:
        return files
    return [files[i::num_core] for i in range(num_core)]


class SingleDataset:
    """Waveforms of one corpus, by index; `num_frames` reads only the
    header, so a batch planner can bucket a corpus without decoding it."""

    def __init__(self, files, query: str = "*.wav", load_fn: str = "audio",
                 return_utt_id: bool = False, subset_num: int = -1):
        self.return_utt_id = return_utt_id
        self.load_fn = load_fn
        self.filenames = _load_list(files)
        if subset_num > 0:
            self.filenames = self.filenames[:subset_num]
        if not self.filenames:
            raise ValueError(f"File list is empty! ({files})")
        self.utt_ids = [os.path.splitext(os.path.basename(f))[0]
                        for f in self.filenames]

    def __len__(self):
        return len(self.filenames)

    def num_frames(self, idx: int) -> int:
        if self.load_fn == "npy":
            return int(np.load(self.filenames[idx], mmap_mode="r").shape[0])
        return wav_info(self.filenames[idx])[2]

    def _load(self, idx: int) -> np.ndarray:
        if self.load_fn == "npy":
            return np.load(self.filenames[idx]).astype(np.float32)
        return read_wav(self.filenames[idx])[0]

    def __getitem__(self, idx: int):
        data = self._load(idx)
        if self.return_utt_id:
            return self.utt_ids[idx], data
        return data


class MultiDataset:
    """N parallel corpora by index, e.g. (noisy, clean) pairs with matching
    file lists (ref: dataloader/dataset.py:99-152)."""

    def __init__(self, multi_files: Sequence, return_utt_id: bool = False):
        self.datasets = [SingleDataset(files) for files in multi_files]
        lengths = [len(d) for d in self.datasets]
        if len(set(lengths)) != 1:
            raise ValueError(f"Corpora lengths differ: {lengths}")
        self.return_utt_id = return_utt_id

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx: int):
        items = [d[idx] for d in self.datasets]
        if self.return_utt_id:
            return self.datasets[0].utt_ids[idx], items
        return items
