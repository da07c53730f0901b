"""Match-list munging (``scripts_python/auxiliar_faldoi_functions.py``).

Port of ``faldoi_tpu/matchers/matchlists.py``: the same output files, named
the same way, with the same text."""

from __future__ import annotations


def cut_matching_list(input_file: str) -> str:
    """Reorder SIFT match_cli columns to ``x0 y0 x1 y1``
    (auxiliar_faldoi_functions.py:19-30)."""
    dest = input_file.split(".txt")[-2] + "_cut.txt"
    with open(input_file) as src, open(dest, "w") as out:
        for line in src:
            c = line.split()
            out.write(f"{c[1]} {c[0]} {c[5]} {c[4]}\n")
    return dest


def cut_deep_list(input_file: str) -> str:
    """Keep the first 4 columns (auxiliar_faldoi_functions.py:32-44)."""
    dest = input_file[:-4] + "_cut.txt"
    with open(input_file) as src, open(dest, "w") as out:
        for line in src:
            c = line.split()
            out.write(f"{c[0]} {c[1]} {c[2]} {c[3]}\n")
    return dest


def delete_outliers(input_file: str, thres: float) -> str:
    """Drop matches whose 5th column score <= threshold
    (auxiliar_faldoi_functions.py:47-64)."""
    th = float(thres)
    dest = input_file[:-4] + "_out.txt"
    with open(input_file) as src, open(dest, "w") as out:
        for line in src:
            c = line.split()
            if float(c[4]) > th:
                out.write(f"{c[0]} {c[1]} {c[2]} {c[3]} {c[4]}\n")
    return dest


def joint_matches(file1: str, file2: str) -> str:
    """Concatenate two 4-column match files
    (auxiliar_faldoi_functions.py:67-85)."""
    dest = file1.split(".")[0] + "_final.txt"
    with open(dest, "w") as out:
        for path in (file1, file2):
            with open(path) as src:
                for line in src:
                    c = line.split()
                    out.write(f"{c[0]} {c[1]} {c[2]} {c[3]}\n")
    return dest
