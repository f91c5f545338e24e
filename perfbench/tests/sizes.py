"""Sizes of the tiny CPU runs."""

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: a tiny run of each driver: sizes a CPU test holds (the cells' widths
#: stay; fewer scenes, seeds and denoise steps)
TINY = {
    "closed_loop": {"set": {"n_randoms": 4, "diffusion_steps": 6},
                    "traffic": {"scenes": 2, "scene_sets": 2,
                                "episode_steps": 3, "trace_steps": 2},
                    "check": {"steps": 2}},
}


def tiny(cell_name, root=ROOT):
    with open(os.path.join(root, "perfbench", "workloads",
                           f"{cell_name}.json")) as f:
        return TINY[json.load(f)["driver"]]
