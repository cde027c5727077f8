"""File-list utilities: recursive find, scp lists, temp-list rewriting;
the port's copy of `qpnet_tpu/data/lists.py` (reference
src/utils/utils.py:131-162, 237-239 and src/utils/utils_pathlist.py:16-87,
the scp "rootpath/wav/..." convention)."""

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


def write_txt(path: str, lines: Sequence[str]) -> None:
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with open(path, "w") as f:
        for line in lines:
            f.write(line + "\n")


def check_filenames(filepathlist: Sequence[str]) -> bool:
    """All paths share the same basename stem."""
    stems = {os.path.splitext(os.path.basename(p))[0] for p in filepathlist}
    return len(stems) == 1


# --- scp temp-list rewriting (reference utils_pathlist.py) -----------------

def path_check(paths: Sequence[str]) -> None:
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(f"{p} does not exist!")


def path_initial(paths: Sequence[str]) -> None:
    for p in paths:
        os.makedirs(p, exist_ok=True)


def _rewrite(line: str, keywords: Sequence[str],
             subwords: Sequence[str]) -> str:
    for k, s in zip(keywords, subwords):
        line = line.replace(k, s)
    return line


def templist(listf: str, templistf: str, rootdir: str,
             keywords: Sequence[str], subwords: Sequence[str]) -> None:
    """Rewrite each scp line replacing keyword_i -> subword_i, prefix with
    `rootdir`, and write a temp list (reference utils_pathlist.py:35-57)."""
    out = []
    for line in read_txt(listf):
        newline = _rewrite(line, keywords, subwords)
        out.append(rootdir + newline if rootdir else newline)
    write_txt(templistf, out)


def templist_eval(replace: bool, feat_format: str, listf: str,
                  templistf: str, outdir: str,
                  keywords: Sequence[str], subwords: Sequence[str]) -> bool:
    """Like templist but skips entries whose output (`outdir` with its
    `feat_id` token substituted) already exists unless `replace`
    (reference utils_pathlist.py:59-87).  Returns False when nothing is
    left to process."""
    out = []
    for line in read_txt(listf):
        newline = _rewrite(line, keywords, subwords)
        feat_id = os.path.splitext(os.path.basename(newline))[0]
        if not replace and os.path.exists(outdir.replace("feat_id", feat_id)):
            continue
        out.append(newline)
    if not out:
        return False
    write_txt(templistf, out)
    return True


def list_initial(replace: bool, feat_format: str, listf: str, templistf: str,
                 outdir: str, keywords: Sequence[str],
                 subwords: Sequence[str]) -> bool:
    os.makedirs(os.path.dirname(outdir), exist_ok=True)
    return templist_eval(replace, feat_format, listf, templistf, outdir,
                         keywords, subwords)


def remove_temp_file(paths: Sequence[str]) -> None:
    for p in paths:
        if os.path.exists(p):
            os.remove(p)
