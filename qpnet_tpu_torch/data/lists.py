"""File-list utilities: recursive find and scp lists."""

from __future__ import annotations

import fnmatch
import os
from typing import List, Sequence


def find_files(directory: str, pattern: str = "*.wav",
               use_dir_name: bool = True) -> List[str]:
    files = []
    for root, _, filenames in os.walk(directory, followlinks=True):
        for filename in fnmatch.filter(filenames, pattern):
            files.append(os.path.join(root, filename))
    if not use_dir_name:
        files = [f.replace(directory + "/", "") for f in files]
    return files


def read_txt(file_list: str) -> List[str]:
    with open(file_list) as f:
        return [line.strip() for line in f if line.strip()]


def check_filenames(filepathlist: Sequence[str]) -> bool:
    """All paths share the same basename stem."""
    stems = {os.path.splitext(os.path.basename(p))[0] for p in filepathlist}
    return len(stems) == 1
