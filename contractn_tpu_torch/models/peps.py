"""PEPS: 2D projected entangled pair states as TN graphs.

Counterpart of ``contractn_tpu/models/peps.py``.  Node tensors are numpy
arrays (drawn from a ``numpy.random.Generator``, as in the JAX package, so
both packages build identical grids); the entry points that contract them
(:mod:`.boundary`, ``TN.contract``) move them to their device.
"""

import numpy as np

from ..network import TN


def peps_tn(rows, cols, bond_dim, phys_dim=None, fill=None, rng=None):
    """Build an open-boundary ``rows x cols`` PEPS grid.

    Each site tensor carries its grid bonds in order (up, left, down, right),
    restricted to the bonds that exist at that position, plus an optional
    trailing physical mode of dimension ``phys_dim``.

    Args:
        rows, cols: grid extent.
        bond_dim: virtual bond dimension.
        phys_dim: physical (dangling) dimension per site; None for a closed
            scalar network (e.g. a partition function).
        fill: value to fill tensors with (default 1.0), ignored if ``rng``.
        rng: optional ``numpy.random.Generator`` for random tensors.

    Returns:
        ``(tn, grid)`` where ``grid[r][c]`` is the site Node.
    """
    tn = TN()
    grid = [[None] * cols for _ in range(rows)]
    for r in range(rows):
        for c in range(cols):
            shape = []
            if r > 0:
                shape.append(bond_dim)  # up
            if c > 0:
                shape.append(bond_dim)  # left
            if r < rows - 1:
                shape.append(bond_dim)  # down
            if c < cols - 1:
                shape.append(bond_dim)  # right
            if phys_dim is not None:
                shape.append(phys_dim)
            shape = tuple(shape)
            if rng is not None:
                tensor = rng.standard_normal(shape) / np.sqrt(bond_dim)
            else:
                tensor = np.full(shape, 1.0 if fill is None else fill)
            grid[r][c] = tn.add_dense_node(tensor, name=f"site_{r}_{c}")

    def axis_of(r, c, direction):
        """Mode index of a direction at site (r, c), given its bond layout."""
        axes = []
        if r > 0:
            axes.append("up")
        if c > 0:
            axes.append("left")
        if r < rows - 1:
            axes.append("down")
        if c < cols - 1:
            axes.append("right")
        return axes.index(direction)

    for r in range(rows):
        for c in range(cols):
            if r < rows - 1:  # vertical bond (r,c)-(r+1,c)
                tn.connect_nodes(
                    grid[r][c], grid[r + 1][c],
                    axis_of(r, c, "down"), axis_of(r + 1, c, "up"),
                )
            if c < cols - 1:  # horizontal bond (r,c)-(r,c+1)
                tn.connect_nodes(
                    grid[r][c], grid[r][c + 1],
                    axis_of(r, c, "right"), axis_of(r, c + 1, "left"),
                )
    return tn, grid
