"""Minimal ONNX reader for TreeEnsembleRegressor models, and their dense
array form.

The reference GuideMaker scores guides with onnxruntime over a 56 KB
skl2onnx TreeEnsembleRegressor (its ``doench_predict.py:114``).  Here a
protobuf wire-format parser of ~100 lines pulls the node and leaf tables
out of the ``.onnx`` file, and the ensemble becomes a set of padded
arrays that ``doench.ensemble_predict`` descends level by level.

No onnx, onnxruntime or protobuf dependency: the wire format is parsed
directly.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

# --- protobuf wire-format primitives ---------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) for every field in a message.

    wire_type 0 -> varint int; 1 -> 8 raw bytes; 2 -> bytes; 5 -> 4 raw bytes.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _packed_floats(val: bytes) -> List[float]:
    return list(struct.unpack(f"<{len(val) // 4}f", val))


def _packed_varints(val: bytes) -> List[int]:
    out = []
    pos = 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        out.append(v)
    return out


def _parse_attribute(buf: bytes) -> Tuple[str, object]:
    """AttributeProto -> (name, python value). Handles f/i/s/floats/ints/strings."""
    name = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    scalar = None
    for field, wire, val in iter_fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:      # f
            scalar = struct.unpack("<f", val)[0]
        elif field == 3:      # i
            scalar = val
        elif field == 4:      # s
            scalar = val.decode()
        elif field == 7:      # floats (packed or repeated)
            floats.extend(_packed_floats(val) if wire == 2 else
                          [struct.unpack("<f", val)[0]])
        elif field == 8:      # ints
            ints.extend(_packed_varints(val) if wire == 2 else [val])
        elif field == 9:      # strings
            strings.append(val)
    if floats:
        return name, floats
    if ints:
        return name, ints
    if strings:
        return name, [s.decode() for s in strings]
    return name, scalar


def parse_tree_ensemble(onnx_path: str) -> Dict[str, object]:
    """Extract the first TreeEnsembleRegressor node's attributes from a model."""
    with open(onnx_path, "rb") as f:
        model = f.read()
    graph = None
    for field, _, val in iter_fields(model):
        if field == 7:  # ModelProto.graph
            graph = val
            break
    if graph is None:
        raise ValueError("no graph found in ONNX model")
    for field, _, val in iter_fields(graph):
        if field != 1:  # GraphProto.node
            continue
        attrs = {}
        op_type = None
        for nfield, _, nval in iter_fields(val):
            if nfield == 4:
                op_type = nval.decode()
            elif nfield == 5:
                aname, aval = _parse_attribute(nval)
                attrs[aname] = aval
        if op_type == "TreeEnsembleRegressor":
            return attrs
    raise ValueError("no TreeEnsembleRegressor node found in ONNX model")


# --- dense-array form --------------------------------------------------------


@dataclass
class TreeEnsemble:
    """Padded dense arrays for an ensemble of binary decision trees.

    All arrays are (n_trees, max_nodes); ``feature``/``threshold`` are only
    meaningful on internal nodes, ``value`` on leaves.  ``children[..., 0]``
    is the true (x <= threshold) branch, ``[..., 1]`` the false branch;
    leaves self-loop so the descent loop is branch-free.
    """
    feature: np.ndarray      # int32
    threshold: np.ndarray    # float32
    children: np.ndarray     # int32 (n_trees, max_nodes, 2)
    is_leaf: np.ndarray      # bool
    value: np.ndarray        # float32 leaf weights
    base_value: float
    max_depth: int

    @classmethod
    def from_attrs(cls, attrs: Dict[str, object]) -> "TreeEnsemble":
        tree_ids = np.asarray(attrs["nodes_treeids"], dtype=np.int64)
        node_ids = np.asarray(attrs["nodes_nodeids"], dtype=np.int64)
        modes = attrs["nodes_modes"]
        feats = np.asarray(attrs["nodes_featureids"], dtype=np.int64)
        vals = np.asarray(attrs["nodes_values"], dtype=np.float32)
        t_true = np.asarray(attrs["nodes_truenodeids"], dtype=np.int64)
        t_false = np.asarray(attrs["nodes_falsenodeids"], dtype=np.int64)

        trees = sorted(set(tree_ids.tolist()))
        tree_pos = {t: i for i, t in enumerate(trees)}
        n_trees = len(trees)
        max_nodes = int(node_ids.max()) + 1

        feature = np.zeros((n_trees, max_nodes), dtype=np.int32)
        threshold = np.zeros((n_trees, max_nodes), dtype=np.float32)
        children = np.zeros((n_trees, max_nodes, 2), dtype=np.int32)
        is_leaf = np.ones((n_trees, max_nodes), dtype=bool)
        value = np.zeros((n_trees, max_nodes), dtype=np.float32)

        for i in range(tree_ids.shape[0]):
            t = tree_pos[int(tree_ids[i])]
            nd = int(node_ids[i])
            if modes[i] == "LEAF":
                children[t, nd] = (nd, nd)
            elif modes[i] == "BRANCH_LEQ":
                feature[t, nd] = feats[i]
                threshold[t, nd] = vals[i]
                children[t, nd] = (int(t_true[i]), int(t_false[i]))
                is_leaf[t, nd] = False
            else:
                raise ValueError(f"unsupported node mode {modes[i]!r}")

        for tt, nd, w in zip(attrs["target_treeids"], attrs["target_nodeids"],
                             attrs["target_weights"]):
            value[tree_pos[int(tt)], int(nd)] = np.float32(w)

        base = attrs.get("base_values") or [0.0]
        depth = _ensemble_depth(children, is_leaf)
        return cls(feature, threshold, children, is_leaf, value,
                   float(base[0]), depth)

    def save_npz(self, path: str) -> None:
        np.savez_compressed(
            path, feature=self.feature, threshold=self.threshold,
            children=self.children, is_leaf=self.is_leaf, value=self.value,
            base_value=np.float32(self.base_value),
            max_depth=np.int32(self.max_depth))

    @classmethod
    def load_npz(cls, path: str) -> "TreeEnsemble":
        z = np.load(path)
        return cls(z["feature"], z["threshold"], z["children"], z["is_leaf"],
                   z["value"], float(z["base_value"]), int(z["max_depth"]))


def _ensemble_depth(children: np.ndarray, is_leaf: np.ndarray) -> int:
    """Longest root-to-leaf path over all trees (iterative, host-side)."""
    n_trees, max_nodes, _ = children.shape
    depth = 0
    for t in range(n_trees):
        stack = [(0, 0)]
        while stack:
            nd, d = stack.pop()
            if is_leaf[t, nd]:
                depth = max(depth, d)
            else:
                stack.append((int(children[t, nd, 0]), d + 1))
                stack.append((int(children[t, nd, 1]), d + 1))
    return depth
