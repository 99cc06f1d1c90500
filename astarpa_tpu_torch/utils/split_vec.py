"""A vector with O(1) amortized removal near a moving split point.

Mirror of `pa-heuristic/src/split_vec.rs:14-33`: the sequence is stored as a
prefix plus a reversed suffix; removals near the current split only shuffle
a few elements between the halves.  Used by :class:`ShContours`, whose
prunes walk (mostly) monotonically through the layers.
"""

from __future__ import annotations


class SplitVec:
    __slots__ = ("prefix", "suffix")

    def __init__(self, items=()):
        self.prefix: list = list(items)
        self.suffix: list = []  # reversed tail

    def __len__(self) -> int:
        return len(self.prefix) + len(self.suffix)

    def push(self, x) -> None:
        if self.suffix:
            self.suffix.insert(0, x)
        else:
            self.prefix.append(x)

    def __getitem__(self, idx: int):
        np = len(self.prefix)
        if idx < np:
            return self.prefix[idx]
        return self.suffix[len(self.suffix) - 1 - (idx - np)]

    def __setitem__(self, idx: int, val) -> None:
        np = len(self.prefix)
        if idx < np:
            self.prefix[idx] = val
        else:
            self.suffix[len(self.suffix) - 1 - (idx - np)] = val

    def remove(self, idx: int) -> None:
        """Remove element ``idx``, moving the split next to it so nearby
        removals stay cheap."""
        np = len(self.prefix)
        if idx < np:
            # Move elements after idx into the suffix, then drop idx.
            self.suffix.extend(reversed(self.prefix[idx + 1 :]))
            del self.prefix[idx:]
        else:
            k = len(self.suffix) - 1 - (idx - np)
            # Move suffix elements above idx into the prefix, then drop idx.
            self.prefix.extend(self.suffix[k + 1 :][::-1])
            del self.suffix[k:]

    def to_list(self) -> list:
        return self.prefix + self.suffix[::-1]
