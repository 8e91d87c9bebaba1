"""State carried across from the JAX package: a port Holder built from
plain numpy data.

``state`` maps ``(index, frame, view, slice)`` to the sorted u64
slice-local bit positions (``row * SLICE_WIDTH + column % SLICE_WIDTH``)
of that fragment — what the JAX fragment gives as
``frag.storage.all_positions()``. This is the port's counterpart of
loading a checkpoint: the same bits, served by the port's executor.
``row_attrs`` maps ``(index, frame)`` and ``column_attrs`` maps ``index``
to ``{id: attribute dict}``, what the JAX package's attribute stores
hold. ``frame_options`` maps ``(index, frame)`` to the frame's options
(a ``FrameOptions`` or a dict of its fields, e.g. ``{"cache_type":
"ranked", "cache_size": 5000}``), so a ranked-cache frame carries across
as a ranked-cache frame; frames it does not name get the defaults.

The direct path needs no export: the port's ``Holder`` opens a data
directory that the JAX package wrote and closed (the same fragment
files, protobuf ``.meta`` files and sqlite attribute stores), and the
JAX package opens one the port wrote.
"""

from __future__ import annotations

import numpy as np

from .models.frame import FrameOptions
from .models.holder import Holder


def holder_from_state(path: str, state: dict, device=None,
                      row_attrs=None, column_attrs=None,
                      frame_options=None, executor_options=None):
    """Open a Holder under ``path``, create the frames of
    ``frame_options`` with their options, import every fragment of
    ``state`` and the attributes, and return ``(holder, executor)``, the
    executor on ``device`` (the card unless the caller passes
    ``"cpu"``) with the keyword arguments ``executor_options`` (e.g.
    ``mesh_min_slices=1`` to pin the device legs)."""
    from .executor import Executor
    holder = Holder(path)
    holder.open()
    for (index, frame), opts in sorted((frame_options or {}).items()):
        if isinstance(opts, dict):
            opts = FrameOptions(**opts)
        holder.create_index_if_not_exists(index) \
            .create_frame_if_not_exists(frame, opts)
    for (index, frame, view, slice), positions in sorted(state.items()):
        fr = holder.create_index_if_not_exists(index) \
            .create_frame_if_not_exists(frame)
        frag = fr.create_view_if_not_exists(view) \
            .create_fragment_if_not_exists(int(slice))
        frag.import_positions(np.asarray(positions, dtype=np.uint64))
    for (index, frame), attrs in sorted((row_attrs or {}).items()):
        holder.create_index_if_not_exists(index) \
            .create_frame_if_not_exists(frame) \
            .row_attr_store.set_bulk_attrs(attrs)
    for index, attrs in sorted((column_attrs or {}).items()):
        holder.create_index_if_not_exists(index) \
            .column_attr_store.set_bulk_attrs(attrs)
    return holder, Executor(holder, device=device,
                            **(executor_options or {}))
