"""Waypoint duplicate filtering (host-side, trivially small).

Exact semantics of Pipeline::filterDuplicates (src/pipeline.cpp:153-180):
greedy in input order; a waypoint within ``min_distance`` of an
already-kept one is a duplicate — the kept slot is replaced when the new
pose's translation is closer to the origin, and comparison stops at the
FIRST match (the reference ``break``s, so later kept waypoints are not
checked).
"""

from __future__ import annotations

from typing import List

import numpy as np


def filter_duplicates(
    waypoints: List[np.ndarray], min_distance: float = 0.1
) -> List[np.ndarray]:
    filtered: List[np.ndarray] = []
    for wp in waypoints:
        wp = np.asarray(wp, np.float32)
        pos = wp[:3, 3]
        is_dup = False
        for i in range(len(filtered)):
            if np.linalg.norm(pos - filtered[i][:3, 3]) < min_distance:
                is_dup = True
                if np.linalg.norm(pos) < np.linalg.norm(filtered[i][:3, 3]):
                    filtered[i] = wp  # replace with the closer-to-origin pose
                break
        if not is_dup:
            filtered.append(wp)
    print(f"Filtered: {len(waypoints)} → {len(filtered)} waypoints")
    return filtered
