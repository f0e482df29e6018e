"""MPS/QPS file reader: a copy of ``madipm_tpu/models/mps.py`` (numpy and
scipy only), with the port's ``QuadraticModel`` and ``models/native.py``.

Equivalent of the QPSReader.jl ingestion used by the reference benchmark
harness (reference: scripts/common.jl:21-36 ``import_mps``): parses fixed- or
free-format MPS including the QPS quadratic extensions (QUADOBJ/QMATRIX) used
by Maros-Meszaros, with transparent gzip/bz2 decompression chosen by file
extension.  Integrality markers (INTORG/INTEND) are parsed and *relaxed* —
MIPLIB instances load as their LP relaxations, matching the reference's
MIPLIB2010-relaxation suite (scripts/benchmarks_cpu.jl:61-70).

Output is a host-side :class:`~madipm_tpu_torch.models.qp.QuadraticModel`.
"""

from __future__ import annotations

import bz2
import gzip
from typing import Iterable, Optional

import numpy as np
import scipy.sparse as sp

from .qp import INF, QuadraticModel


def _open_lines(path: str) -> Iterable[str]:
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            yield from f
    elif path.endswith(".bz2"):
        with bz2.open(path, "rt") as f:
            yield from f
    else:
        with open(path, "r") as f:
            yield from f


def read_mps(
    path: str,
    name: Optional[str] = None,
    use_native: Optional[bool] = None,
    fixed: Optional[bool] = None,
) -> QuadraticModel:
    """Parse an MPS/QPS file (optionally .gz/.bz2) into a QuadraticModel.

    ``use_native=None`` (auto) uses the C++ parser (native/mps_native.cpp)
    when the library is available, falling back to this module's Python
    implementation; True forces native, False forces Python.

    ``fixed=None`` (auto) first parses free-format (whitespace tokens); if
    that raises or leaves unresolved row references (the signature of
    FIXED-format files whose names contain embedded spaces — real Netlib
    has such files), it re-parses with column-anchored fields (classic
    fixed MPS: fields at columns 2-3, 5-12, 15-22, 25-36, 40-47, 50-61)
    and keeps whichever parse resolved every reference.  True/False force
    the format.
    """

    def _parse(txt, fx):
        if use_native is not False:
            try:
                from .native import available, native_parse_mps

                if available():
                    return native_parse_mps(txt, name=name or path, fixed=fx)
                if use_native:
                    raise RuntimeError("native MPS parser requested but unavailable")
            except RuntimeError:
                if use_native:
                    raise
        return parse_mps(txt.splitlines(keepends=True), name=name or path, fixed=fx)

    text = "".join(_open_lines(path))
    if fixed is not None:
        return _parse(text, fixed)
    try:
        model = _parse(text, False)
        if getattr(model, "_n_unknown_refs", 0) == 0:
            return model
    except (ValueError, IndexError):
        model = None
    try:
        model_fx = _parse(text, True)
    except (ValueError, IndexError):
        model_fx = None
    if model_fx is not None and getattr(model_fx, "_n_unknown_refs", 0) == 0:
        return model_fx
    if model is not None:
        return model
    if model_fx is not None:
        return model_fx
    # Both failed: re-raise the free-format error for the clearest message.
    return _parse(text, False)


#: classic fixed-MPS field positions (0-indexed, end-exclusive):
#: F1 type, F2 name, F3 name, F4 value, F5 name, F6 value.
_FIXED_FIELDS = ((1, 3), (4, 12), (14, 22), (24, 36), (39, 47), (49, 61))


def _fixed_split(line: str):
    """Extract the six fixed-format fields (stripped; '' when blank).

    Names keep EMBEDDED spaces (only ends stripped) — the whole point of
    fixed format.  A ``$`` starting field 3 or 5 comments out the rest of
    the line (standard fixed-MPS comment convention).
    """
    out = []
    for k, (a, b) in enumerate(_FIXED_FIELDS):
        f = line[a:b].strip() if len(line) > a else ""
        if k in (2, 4) and f.startswith("$"):
            out.extend([""] * (6 - k))
            break
        out.append(f)
    while len(out) < 6:
        out.append("")
    return out


def parse_mps(lines: Iterable[str], name: str = "mps", fixed: bool = False) -> QuadraticModel:
    section = None
    obj_name = None
    prob_name = name
    maximize = False

    row_type: dict[str, str] = {}  # name -> L/G/E
    row_order: list[str] = []
    col_order: list[str] = []
    col_index: dict[str, int] = {}
    row_index: dict[str, int] = {}

    a_rows: list[int] = []
    a_cols: list[int] = []
    a_vals: list[float] = []
    c_entries: dict[int, float] = {}
    c0 = 0.0
    rhs: dict[int, float] = {}
    ranges: dict[int, float] = {}
    lb: dict[int, float] = {}
    ub: dict[int, float] = {}
    explicit_lb: set[int] = set()
    integer_cols: set[int] = set()

    q_rows: list[int] = []
    q_cols: list[int] = []
    q_vals: list[float] = []
    q_section = None  # 'QUADOBJ' (lower tri) or 'QMATRIX' (full)

    in_integer = False
    pending_objsense = False

    def col_id(cname: str) -> int:
        if cname not in col_index:
            col_index[cname] = len(col_order)
            col_order.append(cname)
        return col_index[cname]

    n_unknown = 0
    _DATA_SECTIONS = ("ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS", "QUAD")

    def _fixed_tok(line: str, section: str):
        """Map the positional fields onto the token shapes the free-format
        body consumes (see _fixed_split for the field layout)."""
        f = _fixed_split(line)
        if section == "ROWS":
            return [t for t in (f[0], f[1]) if t]
        if section in ("COLUMNS", "QUAD"):
            if f[2].upper() == "'MARKER'":
                return [f[1], f[2], f[4]]
            tok = [f[1]]
            for a, b in ((f[2], f[3]), (f[4], f[5])):
                if a and b:
                    tok.extend([a, b])
            return tok
        if section in ("RHS", "RANGES"):
            tok = [f[1]] if f[1] else []
            for a, b in ((f[2], f[3]), (f[4], f[5])):
                if a and b:
                    tok.extend([a, b])
            return tok
        # BOUNDS: type, set name (placeholder when blank), column, value
        tok = [f[0], f[1] or "BND", f[2]]
        if f[3]:
            tok.append(f[3])
        return tok

    for raw in lines:
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        is_header = not raw[0].isspace()
        line = raw.rstrip("\n")
        if fixed and not is_header and section in _DATA_SECTIONS:
            tok = _fixed_tok(line, section)
            if not tok:
                continue
        else:
            tok = line.split()
            # Free-format `$` comment: a token starting with $ ends the line.
            for ci, t in enumerate(tok):
                if t.startswith("$"):
                    tok = tok[:ci]
                    break
            if not tok:
                continue
        if is_header:
            head = tok[0].upper()
            if head == "NAME":
                prob_name = tok[1] if len(tok) > 1 else name
                section = None
            elif head == "OBJSENSE":
                section = "OBJSENSE"
                if len(tok) > 1:
                    maximize = tok[1].upper() in ("MAX", "MAXIMIZE")
                else:
                    pending_objsense = True
            elif head in ("ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS", "ENDATA"):
                section = head
            elif head in ("QUADOBJ", "QMATRIX", "QSECTION"):
                section = "QUAD"
                q_section = "QMATRIX" if head == "QMATRIX" else "QUADOBJ"
            else:
                section = head  # unknown section: skip its body
            if head == "ENDATA":
                break
            continue

        if section == "OBJSENSE" and pending_objsense:
            maximize = tok[0].upper() in ("MAX", "MAXIMIZE")
            pending_objsense = False
        elif section == "ROWS":
            rtype, rname = tok[0].upper(), tok[1]
            if rtype == "N":
                if obj_name is None:
                    obj_name = rname
                # extra N rows are ignored (free rows)
            else:
                row_type[rname] = rtype
                row_index[rname] = len(row_order)
                row_order.append(rname)
        elif section == "COLUMNS":
            if len(tok) >= 3 and tok[1].upper() == "'MARKER'":
                marker = tok[2].upper().strip("'")
                if "INTORG" in raw.upper():
                    in_integer = True
                elif "INTEND" in raw.upper():
                    in_integer = False
                continue
            cname = tok[0]
            j = col_id(cname)
            if in_integer:
                integer_cols.add(j)
            for k in range(1, len(tok) - 1, 2):
                rname, val = tok[k], float(tok[k + 1])
                if rname == obj_name:
                    c_entries[j] = c_entries.get(j, 0.0) + val
                elif rname in row_index:
                    a_rows.append(row_index[rname])
                    a_cols.append(j)
                    a_vals.append(val)
                else:
                    # Unknown/free-row reference: dropped, but counted —
                    # a nonzero count after a free-format parse is the
                    # fixed-format-file signature read_mps keys on.
                    n_unknown += 1
        elif section == "RHS":
            # first token is the RHS-set name (sometimes omitted -> even count)
            start = 1 if len(tok) % 2 == 1 else 0
            for k in range(start, len(tok) - 1, 2):
                rname, val = tok[k], float(tok[k + 1])
                if rname == obj_name:
                    c0 = -val  # objective constant enters negated
                elif rname in row_index:
                    rhs[row_index[rname]] = val
                else:
                    n_unknown += 1
        elif section == "RANGES":
            start = 1 if len(tok) % 2 == 1 else 0
            for k in range(start, len(tok) - 1, 2):
                rname, val = tok[k], float(tok[k + 1])
                if rname in row_index:
                    ranges[row_index[rname]] = val
        elif section == "BOUNDS":
            btype = tok[0].upper()
            # "BTYPE SET COL [VAL]"; the bound-set name may be omitted
            # ("BTYPE COL [VAL]") — detected by whether the value-carrying
            # types find a number in the VAL slot.
            needs_val = btype in ("UP", "LO", "FX", "UI", "LI")
            cname, val = None, 0.0
            if needs_val:
                if len(tok) >= 4:
                    cname, val = tok[2], float(tok[3])
                elif len(tok) == 3:
                    try:  # omitted set name: "UP COL 4.0"
                        val = float(tok[2])
                        cname = tok[1]
                    except ValueError:
                        cname = tok[2]  # malformed: value missing, keep 0.0
            else:  # FR/MI/PL/BV take no value
                cname = tok[2] if len(tok) >= 3 else tok[1]
            j = col_id(cname)
            if btype == "UP":
                ub[j] = val
                if val < 0 and j not in explicit_lb:
                    lb[j] = -INF  # classic MPS convention
            elif btype == "LO":
                lb[j] = val
                explicit_lb.add(j)
            elif btype == "FX":
                lb[j] = val
                ub[j] = val
                explicit_lb.add(j)
            elif btype == "FR":
                lb[j] = -INF
                ub[j] = INF
                explicit_lb.add(j)
            elif btype == "MI":
                lb[j] = -INF
                explicit_lb.add(j)
            elif btype == "PL":
                ub[j] = INF
            elif btype == "BV":
                lb[j] = 0.0
                ub[j] = 1.0
                integer_cols.add(j)
                explicit_lb.add(j)
            elif btype == "UI":
                ub[j] = val
                integer_cols.add(j)
            elif btype == "LI":
                lb[j] = val
                integer_cols.add(j)
                explicit_lb.add(j)
        elif section == "QUAD":
            cname1 = tok[0]
            for k in range(1, len(tok) - 1, 2):
                cname2, val = tok[k], float(tok[k + 1])
                q_rows.append(col_id(cname1))
                q_cols.append(col_id(cname2))
                q_vals.append(val)

    n = len(col_order)
    m = len(row_order)

    c = np.zeros(n)
    for j, v in c_entries.items():
        c[j] = v

    lvar = np.zeros(n)
    uvar = np.full(n, INF)
    for j, v in lb.items():
        lvar[j] = v
    for j, v in ub.items():
        uvar[j] = v

    lcon = np.full(m, -INF)
    ucon = np.full(m, INF)
    for i, rname in enumerate(row_order):
        t = row_type[rname]
        r = rhs.get(i, 0.0)
        if t == "L":
            ucon[i] = r
        elif t == "G":
            lcon[i] = r
        else:  # E
            lcon[i] = r
            ucon[i] = r
    for i, rng_ in ranges.items():
        t = row_type[row_order[i]]
        r = rhs.get(i, 0.0)
        if t == "L":
            lcon[i] = ucon[i] - abs(rng_)
        elif t == "G":
            ucon[i] = lcon[i] + abs(rng_)
        else:  # E
            if rng_ >= 0:
                ucon[i] = r + rng_
            else:
                lcon[i] = r + rng_

    A = sp.csr_matrix((a_vals, (a_rows, a_cols)), shape=(m, n))

    Q = None
    if q_vals:
        if q_section == "QUADOBJ":
            # lower-triangular entries of the symmetric Q in 1/2 x'Qx
            Q = sp.csr_matrix((q_vals, (q_rows, q_cols)), shape=(n, n))
        else:  # QMATRIX lists the full matrix
            Qf = sp.csr_matrix((q_vals, (q_rows, q_cols)), shape=(n, n))
            Q = sp.tril(Qf, format="csr")

    model = QuadraticModel(
        c=c,
        A=A,
        lcon=lcon,
        ucon=ucon,
        lvar=lvar,
        uvar=uvar,
        Q=Q,
        c0=c0,
        name=prob_name,
        minimize=not maximize,  # madipm() negates + flips for maximization
    )
    model._integer_cols = sorted(integer_cols)  # type: ignore[attr-defined]
    model._n_unknown_refs = n_unknown  # type: ignore[attr-defined]
    return model


# ---------------------------------------------------------------------------
# Writer (QPSReader has no writer; this closes the roundtrip so the parsers
# can be property-tested offline — VERDICT round-2 directive #5)
# ---------------------------------------------------------------------------


def write_mps(qp: QuadraticModel, path: str, name: Optional[str] = None) -> None:
    """Write a QuadraticModel as a free-format MPS/QPS file.

    Emits generated names (``Cj`` / ``Ri``; QuadraticModel carries no
    per-variable names) and full-precision values (%.17g — exact float64
    roundtrip).  Rows are classified E/G/L from (lcon, ucon); two-sided
    rows become G + a RANGES entry; rows with neither bound become free N
    rows (vacuous constraints — their coefficients are dropped on
    re-read, which preserves the feasible set).  The objective constant
    is written as RHS on the objective row (negated, the MPS
    convention).  Bounds emit LO/UP/FX/FR/MI with an explicit ``LO 0``
    before any negative UP so the classic negative-upper convention
    cannot fire on re-read.  The Hessian (if any) goes to QUADOBJ as the
    lower triangle of the symmetric Q in 1/2 x'Qx.
    """
    n, m = qp.nvar, qp.ncon
    g = lambda v: f"{v:.17g}"
    cn = [f"C{j}" for j in range(n)]
    rn = [f"R{i}" for i in range(m)]

    lines = [f"NAME          {name or qp.name or 'madipm'}"]
    if not qp.minimize:
        lines.append("OBJSENSE")
        lines.append("    MAXIMIZE")

    lines.append("ROWS")
    lines.append(" N  OBJ")
    rtype = []
    for i in range(m):
        lc, uc = qp.lcon[i], qp.ucon[i]
        if np.isfinite(lc) and np.isfinite(uc):
            t = "E" if lc == uc else "G"  # two-sided: G + RANGES
        elif np.isfinite(lc):
            t = "G"
        elif np.isfinite(uc):
            t = "L"
        else:
            t = "N"  # vacuous row
        rtype.append(t)
        lines.append(f" {t}  {rn[i]}")

    lines.append("COLUMNS")
    A_csc = qp.A.tocsc()
    for j in range(n):
        emitted = False
        if qp.c[j] != 0.0:
            lines.append(f"    {cn[j]:<10}OBJ       {g(qp.c[j])}")
            emitted = True
        lo, hi = A_csc.indptr[j], A_csc.indptr[j + 1]
        for p in range(lo, hi):
            i = A_csc.indices[p]
            if rtype[i] == "N" or A_csc.data[p] == 0.0:
                continue
            lines.append(f"    {cn[j]:<10}{rn[i]:<10}{g(A_csc.data[p])}")
            emitted = True
        if not emitted:
            # Structurally empty column with zero cost: declare it anyway
            # (a zero OBJ entry) so the variable — and the global column
            # ORDER — survive the roundtrip.
            lines.append(f"    {cn[j]:<10}OBJ       0")

    lines.append("RHS")
    if qp.c0 != 0.0:
        lines.append(f"    RHS       OBJ       {g(-qp.c0)}")
    for i in range(m):
        t = rtype[i]
        if t == "N":
            continue
        r = qp.lcon[i] if t in ("E", "G") else qp.ucon[i]
        if r != 0.0:
            lines.append(f"    RHS       {rn[i]:<10}{g(r)}")

    rng_lines = []
    for i in range(m):
        if rtype[i] == "G" and np.isfinite(qp.ucon[i]):
            rng_lines.append(
                f"    RNG       {rn[i]:<10}{g(qp.ucon[i] - qp.lcon[i])}"
            )
    if rng_lines:
        lines.append("RANGES")
        lines.extend(rng_lines)

    bnd_lines = []
    for j in range(n):
        lb, ub = qp.lvar[j], qp.uvar[j]
        if lb == 0.0 and ub == INF:
            continue
        if lb == ub:
            bnd_lines.append(f" FX BND       {cn[j]:<10}{g(lb)}")
            continue
        if lb == -INF and ub == INF:
            bnd_lines.append(f" FR BND       {cn[j]}")
            continue
        if lb == -INF:
            bnd_lines.append(f" MI BND       {cn[j]}")
        elif lb != 0.0 or (np.isfinite(ub) and ub < 0):
            # explicit LO (also disarms the negative-UP convention)
            bnd_lines.append(f" LO BND       {cn[j]:<10}{g(lb)}")
        if np.isfinite(ub):
            bnd_lines.append(f" UP BND       {cn[j]:<10}{g(ub)}")
    if bnd_lines:
        lines.append("BOUNDS")
        lines.extend(bnd_lines)

    if qp.Q is not None:
        ql = sp.tril(qp.Q).tocoo()
        lines.append("QUADOBJ")
        for i_, j_, v_ in zip(ql.row, ql.col, ql.data):
            if v_ != 0.0:
                lines.append(f"    {cn[i_]:<10}{cn[j_]:<10}{g(v_)}")

    lines.append("ENDATA")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
