"""Columnar JSONL emission via the native template VM.

Builds "programs" for `msm_emit_jsonl` (ingest/native/src/jsonl_emit.cpp):
a record layout is compiled once into literal segments + column ops +
selector subprograms, then the native emitter assembles and writes every
row directly from NumPy columns (~20x the per-row cost of Python dict +
json.dumps assembly). Falls back to a pure-Python interpreter of the same
program when the native library is unavailable, so outputs are identical
either way.
"""

from __future__ import annotations

import ctypes
import json

import numpy as np

from ..ingest import native

OP_LIT, OP_STR, OP_INT, OP_FLT, OP_SEL = range(5)


def escape(text: str) -> str:
    """JSON string-body escaping identical to json.dumps (ensure_ascii)."""
    return json.dumps(text)[1:-1]


class EmitProgram:
    """Record-layout builder over columnar inputs."""

    def __init__(self, n_rows: int):
        self.n_rows = n_rows
        self.literals: list[str] = []
        self._literal_ids: dict[str, int] = {}
        self.string_table: list[str] = []
        self._string_ids: dict[str, int] = {}
        self.str_cols: list[np.ndarray] = []
        self.int_cols: list[np.ndarray] = []
        self.float_cols: list[np.ndarray] = []
        self.subprograms: list[list[tuple]] = []

    # -- columns --------------------------------------------------------

    def add_int_col(self, values) -> int:
        col = np.ascontiguousarray(values, dtype=np.int64)
        assert col.shape == (self.n_rows,)
        self.int_cols.append(col)
        return len(self.int_cols) - 1

    def add_float_col(self, values) -> int:
        col = np.ascontiguousarray(values, dtype=np.float64)
        assert col.shape == (self.n_rows,)
        self.float_cols.append(col)
        return len(self.float_cols) - 1

    def add_str_col(self, values, pre_escaped: bool = False) -> int:
        """Column of strings; deduplicated into the global string table.
        Escape/dedupe run once per *unique* value (scene/image columns are
        highly repetitive)."""
        arr = np.asarray(values, dtype=str)
        uniques, inverse = np.unique(arr, return_inverse=True)
        return self.add_coded_str_col(inverse, uniques,
                                      pre_escaped=pre_escaped)

    def add_coded_str_col(self, codes, strings,
                          pre_escaped: bool = False) -> int:
        """String column already factored into (codes, unique strings) —
        skips the per-call np.unique over row strings (PreparedRelations
        carries table-wide codes, so repeated emits dedupe nothing)."""
        remap = np.empty(len(strings), dtype=np.int64)
        for u, v in enumerate(strings):
            s = v if pre_escaped else escape(str(v))
            j = self._string_ids.get(s)
            if j is None:
                j = len(self.string_table)
                self._string_ids[s] = j
                self.string_table.append(s)
            remap[u] = j
        self.str_cols.append(remap[np.asarray(codes, dtype=np.int64)])
        return len(self.str_cols) - 1

    # -- ops ------------------------------------------------------------

    def _lit_id(self, text: str) -> int:
        i = self._literal_ids.get(text)
        if i is None:
            i = len(self.literals)
            self._literal_ids[text] = i
            self.literals.append(text)
        return i

    def lit(self, ops: list, raw_text: str) -> None:
        """Append raw bytes (caller handles any JSON escaping)."""
        ops.append((OP_LIT, self._lit_id(raw_text), 0))

    def lit_json(self, ops: list, text: str) -> None:
        """Append a string body, JSON-escaped."""
        self.lit(ops, escape(text))

    def strv(self, ops: list, col: int) -> None:
        ops.append((OP_STR, col, 0))

    def intv(self, ops: list, col: int) -> None:
        ops.append((OP_INT, col, 0))

    def fltv(self, ops: list, col: int) -> None:
        ops.append((OP_FLT, col, 0))

    def select(self, ops: list, selector_col: int,
               subprograms: list[list[tuple]]) -> None:
        ops.append(self.make_select(selector_col, subprograms))

    def template_subprogram(self, template: str, field_ops: dict) -> list:
        """Split a `{placeholder}` template into a subprogram; field_ops
        maps field name -> list of ops emitting its value."""
        import string

        ops: list[tuple] = []
        for literal, field, spec, conv in string.Formatter().parse(template):
            if literal:
                self.lit_json(ops, literal)
            if field is not None:
                assert not spec and not conv, (template, field)
                ops.extend(field_ops[field])
        return ops

    def ops_for(self, build) -> list:
        """Convenience: run `build(ops)` on a fresh list and return it."""
        ops: list[tuple] = []
        build(ops)
        return ops

    # -- execution ------------------------------------------------------

    def make_select(self, selector_col: int,
                    subprograms: list[list[tuple]]) -> tuple:
        """Register subprograms once and return a reusable SEL op."""
        base = len(self.subprograms)
        self.subprograms.extend(subprograms)
        return (OP_SEL, selector_col, base)

    # -- execution ------------------------------------------------------

    def emit(self, main_ops: list, out_path: str,
             row_order: np.ndarray | None = None,
             force_python: bool = False) -> None:
        import os

        from ..core.io import mkdir_or_exist

        mkdir_or_exist(os.path.dirname(out_path))
        if not force_python and native.native_available() and \
                _emit_native(self, main_ops, out_path, row_order):
            return
        _emit_python(self, main_ops, out_path, row_order)


def _flatten(program: EmitProgram, main_ops: list):
    all_progs = program.subprograms + [main_ops]
    flat: list[tuple] = []
    offsets, lengths = [], []
    for ops in all_progs:
        offsets.append(len(flat))
        lengths.append(len(ops))
        flat.extend(ops)
    arr = np.asarray(flat, dtype=np.int32).reshape(-1, 3) if flat else \
        np.zeros((0, 3), dtype=np.int32)
    return (arr, np.asarray(offsets[:-1] or [0], dtype=np.int64),
            np.asarray(lengths[:-1] or [0], dtype=np.int64),
            offsets[-1], lengths[-1])


def _emit_native(program: EmitProgram, main_ops: list, out_path: str,
                 row_order) -> bool:
    import os

    lib = native._load()
    if lib is None:
        return False
    if not hasattr(lib, "msm_emit_jsonl_configured"):
        # multithreaded entry point (rows render in parallel, output
        # byte-identical for any thread count); falls back to the
        # single-threaded symbol for libraries built before it existed
        fn = getattr(lib, "msm_emit_jsonl_mt", None) or lib.msm_emit_jsonl
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ] + ([ctypes.c_int32] if fn is not lib.msm_emit_jsonl else [])
        lib.msm_emit_jsonl_configured = fn
        lib.msm_emit_jsonl_is_mt = fn is not lib.msm_emit_jsonl

    flat, sub_off, sub_len, main_off, main_len = _flatten(program, main_ops)
    n = program.n_rows
    literals = (ctypes.c_char_p * max(len(program.literals), 1))(
        *[s.encode() for s in program.literals] or [b""])
    table = (ctypes.c_char_p * max(len(program.string_table), 1))(
        *[s.encode() for s in program.string_table] or [b""])
    str_idx = (np.stack(program.str_cols) if program.str_cols
               else np.zeros((1, n), dtype=np.int64))
    int_cols = (np.stack(program.int_cols) if program.int_cols
                else np.zeros((1, n), dtype=np.int64))
    float_cols = (np.stack(program.float_cols) if program.float_cols
                  else np.zeros((1, n), dtype=np.float64))
    str_idx = np.ascontiguousarray(str_idx, dtype=np.int64)
    int_cols = np.ascontiguousarray(int_cols, dtype=np.int64)
    float_cols = np.ascontiguousarray(float_cols, dtype=np.float64)
    order = (np.ascontiguousarray(row_order, dtype=np.int64)
             if row_order is not None else None)
    n_out = n if order is None else len(order)
    args = [
        out_path.encode(), n, n_out, literals, table,
        str_idx.ctypes.data_as(ctypes.c_void_p),
        int_cols.ctypes.data_as(ctypes.c_void_p),
        float_cols.ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(flat).ctypes.data_as(ctypes.c_void_p),
        sub_off.ctypes.data_as(ctypes.c_void_p),
        sub_len.ctypes.data_as(ctypes.c_void_p),
        main_off, main_len,
        order.ctypes.data_as(ctypes.c_void_p) if order is not None else None,
    ]
    fn = lib.msm_emit_jsonl_configured
    if lib.msm_emit_jsonl_is_mt:
        args.append(os.cpu_count() or 1)
    rc = fn(*args)
    return rc == 0


def _format_float(v: float) -> str:
    """Exactly json.dumps' float spelling: repr() (shortest round-trip,
    '2.0' not '2') for finite values, NaN/Infinity spellings otherwise."""
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "Infinity"
    if v == float("-inf"):
        return "-Infinity"
    return repr(v)


def _emit_python(program: EmitProgram, main_ops: list, out_path: str,
                 row_order) -> None:
    """Reference interpreter of the emit program (identical output)."""
    flat, sub_off, sub_len, main_off, main_len = _flatten(program, main_ops)
    all_progs = program.subprograms + [main_ops]

    def run(ops, row, parts):
        for op, a, b in ops:
            if op == OP_LIT:
                parts.append(program.literals[a])
            elif op == OP_STR:
                parts.append(
                    program.string_table[program.str_cols[a][row]])
            elif op == OP_INT:
                parts.append(str(int(program.int_cols[a][row])))
            elif op == OP_FLT:
                parts.append(_format_float(float(program.float_cols[a][row])))
            elif op == OP_SEL:
                sel = int(program.int_cols[a][row])
                run(all_progs[b + sel], row, parts)

    order = row_order if row_order is not None else range(program.n_rows)
    from ..core.io import mkdir_or_exist
    import os

    mkdir_or_exist(os.path.dirname(out_path))
    with open(out_path, "w") as f:
        for row in order:
            parts: list[str] = []
            run(main_ops, int(row), parts)
            f.write("".join(parts))
            f.write("\n")
