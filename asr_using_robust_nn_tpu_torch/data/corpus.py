"""Corpus walking and labeling for both reference layouts. A copy of the JAX
package's `data/corpus.py`.

Digit task: `data/<word>/*.wav`, 10 digit words, label = word index in the
canonical list. Speaker task: `dataset/rodigits/<speaker>/*.wav`, label =
sorted folder index.

Fixes over the reference scripts, kept from the JAX package: portable path
separators instead of hard-coded '\\\\'; labels derived from the same sorted
listing that produced the filenames (the reference counted os.listdir
separately and assumed equal order and count).
"""

from __future__ import annotations

import os

import numpy as np

DIGIT_WORDS = [
    "zero", "one", "two", "three", "four",
    "five", "six", "seven", "eight", "nine",
]

__all__ = ["DIGIT_WORDS", "walk_corpus"]


def walk_corpus(
    data_dir, class_names: list[str] | None = None, extensions=(".wav",)
) -> tuple[list[str], np.ndarray, list[str]]:
    """Enumerate `<data_dir>/<class>/<file>` -> (filenames, int labels, classes).

    `class_names=None` uses every subfolder in sorted order (speaker layout);
    pass `DIGIT_WORDS` for the digit layout, where only the ten digit folders
    participate and label = index in that list.
    """
    data_dir = str(data_dir)
    if class_names is None:
        class_names = sorted(
            d for d in os.listdir(data_dir)
            if os.path.isdir(os.path.join(data_dir, d))
        )
    else:
        present = set(os.listdir(data_dir))
        missing = [c for c in class_names if c not in present]
        if missing:
            # labels stay the index into the original list so a partial
            # corpus cannot silently shift class ids (the reference
            # re-indexes over the folders present)
            import warnings

            warnings.warn(
                f"class folders missing under {data_dir!r}: {missing}; "
                f"their labels are reserved, not reassigned", stacklevel=2
            )
    filenames: list[str] = []
    labels: list[int] = []
    for i, cls in enumerate(class_names):
        d = os.path.join(data_dir, cls)
        if not os.path.isdir(d):
            continue
        # os.listdir, not glob: glob metacharacters in data_dir or a class
        # folder name ('run[1]', 'spk?') would silently match nothing and
        # drop the class with no warning
        files = sorted(
            os.path.join(d, f) for f in os.listdir(d)
            if f.lower().endswith(tuple(extensions))
        )
        filenames.extend(files)
        labels.extend([i] * len(files))
    return filenames, np.asarray(labels, dtype=np.int64), list(class_names)
