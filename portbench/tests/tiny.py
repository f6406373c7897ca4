"""A cell of the benchmark cut to a size the CPU tests can run: the same
configuration and traffic mix at a small frame, on the port's CPU
route."""

import copy
import dataclasses

from portbench.harness.cells import load_cell


def tiny_cell(name: str, w: int = 128, h: int = 96, limits=None):
    cell = load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["encoder"].update(width=w, height=h)
    cfg["guarantees"].update(coded_size=[(w + 31) // 32 * 32,
                                         (h + 31) // 32 * 32],
                             render_size=[w, h])
    tr = dataclasses.replace(cell.traffic, texture_hw=(h + 96, w + 128))
    return dataclasses.replace(cell, config=cfg, traffic=tr,
                               limits=dict(limits or cell.limits))
