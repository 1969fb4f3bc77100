"""OpenQASM 3.0 (and 2.0-subset) parser: a copy of
``rocquantum_tpu/compiler/qasm_parser.py`` over this package's IR.

Covers the subset emitted by compiler/qasm.py plus, beyond the reference
(which had QASM emission only, circuit.py:68-96):

* custom gate definitions — ``gate name(p0, p1) a, b { ... }`` — expanded
  at use sites with parameter-expression substitution;
* mid-circuit measurement — ``c[k] = measure q[i];`` / 2.0
  ``measure q[i] -> c[k];``;
* classical control — ``if (c[k] == 1) { ... }`` / single-statement and
  2.0 ``if (c == 1) x q[0];`` forms;
* classical ``for`` loops — ``for int i in [0:n-1] { ... }`` (also
  ``[start:step:stop]``), unrolled at parse time with the loop variable
  usable in parameter expressions AND qubit indices (``q[i+1]``);
* classical ``while`` loops — ``while (c[k] == 1) { ... }`` — whose
  bodies may re-measure (repeat-until-success); executed shot-batched
  with per-shot active masks, bounded by :data:`WHILE_MAX_ITERATIONS`;
* ``def`` subroutines — ``def name(qubit a, float x) { ... }`` — bodies
  may contain gates, measurements, ``if``/``for``/``while``; expanded at
  call sites (``name(q[0], 0.5);``) with qubit and classical argument
  substitution; ``-> bit`` subroutines end with ``return measure <q>;``
  and are called captured (``c[k] = name(...);`` — the return lowers to a
  measurement into ``c[k]``);
* ``switch`` statements — ``switch (c) { case 1 { } case 2, 3 { }
  default { } }`` (also ``switch (c[k])``) — arm bodies are full
  statement blocks (may measure/branch/loop), executed shot-batched with
  one mask per matched arm;
* gate modifiers — ``inv @``, ``pow(k) @`` (integer k), ``ctrl(n) @``,
  ``negctrl @`` — composable, including over user-defined gates.

``parse_qasm3`` returns a plain :class:`CircuitIR` for static circuits
(raising on dynamic constructs), matching its original contract;
``parse_qasm3_program`` returns a :class:`DynamicProgram` whose items may
also be :class:`Measure` / :class:`Cond` — in the JAX package executed
shot-batched by its compiler/dynamic.py (the reference's dynamic-circuit
semantics, examples/dynamic_circuit_example.py, reachable from QASM); this
package parses them but does not execute them yet.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

from .ir import CircuitIR, GateOp

_CTRL_RE = re.compile(
    r"^ctrl\((?P<n>\d+)\)\s*@\s*(?P<name>[a-z]+)\s*"
    r"(?P<args>q\[[^\]]+\](?:\s*,\s*q\[[^\]]+\])*)\s*;$")
_QREG_RE = re.compile(r"^qubit\[(\d+)\]\s+q\s*;$")
_QREG2_RE = re.compile(r"^qreg\s+q\[(\d+)\]\s*;$")  # OpenQASM 2.0
_CREG_RE = re.compile(r"^(?:bit\[(\d+)\]\s+c|creg\s+c\[(\d+)\])\s*;$")
_MEAS3_RE = re.compile(
    r"^c\[(?P<c>[^\]]+)\]\s*=\s*measure\s+q\[(?P<q>[^\]]+)\]\s*;$")
_MEAS2_RE = re.compile(
    r"^measure\s+q\[(?P<q>[^\]]+)\]\s*->\s*c\[(?P<c>[^\]]+)\]\s*;$")
_IF_RE = re.compile(
    r"^if\s*\(\s*c(?:\[(?P<bit>\d+)\])?\s*==\s*(?P<val>\d+)\s*\)\s*"
    r"(?P<rest>.*)$")
_FOR_RE = re.compile(
    r"^for\s+(?:u?int(?:\[\d+\])?\s+)?(?P<var>[a-zA-Z_]\w*)\s+in\s+"
    r"\[(?P<range>[^\]]+)\]\s*\{$")
_GATEDEF_RE = re.compile(
    r"^gate\s+(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)\s*"
    r"(?:\((?P<params>[^)]*)\))?\s*(?P<args>[a-zA-Z_][\w\s,]*)\s*\{")
_WHILE_RE = re.compile(
    r"^while\s*\(\s*c(?:\[(?P<bit>\d+)\])?\s*==\s*(?P<val>\d+)\s*\)\s*\{")
_DEF_RE = re.compile(
    r"^def\s+(?P<name>[a-zA-Z_]\w*)\s*\((?P<args>[^)]*)\)\s*"
    r"(?:->\s*(?P<ret>[\w\[\]]+)\s*)?\{")
_DEFCALL_RE = re.compile(r"^(?P<name>[a-zA-Z_]\w*)\s*\((?P<args>[^)]*)\)\s*;$")
_DEFRETCALL_RE = re.compile(
    r"^c\[(?P<c>[^\]]+)\]\s*=\s*(?P<name>[a-zA-Z_]\w*)\s*"
    r"\((?P<args>[^)]*)\)\s*;$")
_RETURN_RE = re.compile(r"^return\s+measure\s+(?P<q>\S+?)\s*;$")
_SWITCH_RE = re.compile(r"^switch\s*\(\s*c(?:\[(?P<bit>\d+)\])?\s*\)\s*\{$")
_CASE_RE = re.compile(r"^case\s+(?P<vals>\d+(?:\s*,\s*\d+)*)\s*\{$")
_DEFAULT_RE = re.compile(r"^default\s*\{$")

# Bounded unrolling for shot-batched ``while`` execution: each iteration
# re-evaluates the per-shot condition mask; shots whose condition went
# false stop evolving. The bound caps pathological never-terminating loops.
WHILE_MAX_ITERATIONS = 100

_NAME_MAP = {
    "h": ("H", 1, 0), "x": ("X", 1, 0), "y": ("Y", 1, 0), "z": ("Z", 1, 0),
    "s": ("S", 1, 0), "sdg": ("SDG", 1, 0), "t": ("T", 1, 0),
    "tdg": ("TDG", 1, 0), "swap": ("SWAP", 2, 0),
    "rx": ("RX", 1, 1), "ry": ("RY", 1, 1), "rz": ("RZ", 1, 1),
    "p": ("P", 1, 1), "u3": ("U3", 1, 3), "rzz": ("RZZ", 2, 1),
}
_CTRL_MAP = {"cx": ("CNOT", 1), "cz": ("CZ", 1), "crx": ("CRX", 1),
             "cry": ("CRY", 1), "crz": ("CRZ", 1), "ccx": ("MCX", 2),
             "cswap": ("CSWAP", 1)}

_EXPR_TOKENS = re.compile(r"^[\w\s+\-*/().]*$")


def _eval_param(expr: str, env: Dict[str, float]) -> float:
    """Evaluate a QASM parameter expression (numbers, pi, formal params,
    + - * / and parentheses only)."""
    expr = expr.strip()
    if not _EXPR_TOKENS.match(expr):
        raise ValueError(f"unsupported parameter expression: {expr!r}")
    names = dict(env)
    names["pi"] = math.pi
    try:
        return float(eval(expr, {"__builtins__": {}}, names))  # noqa: S307
    except Exception as exc:
        raise ValueError(f"cannot evaluate parameter {expr!r}: {exc}") from exc


@dataclasses.dataclass
class Measure:
    """Mid-circuit measurement of qubit -> classical bit."""
    qubit: int
    clbit: int


@dataclasses.dataclass
class Cond:
    """Apply ``ops`` when classical bit (or whole register when clbit is
    None) equals ``value``."""
    clbit: Optional[int]
    value: int
    ops: List[GateOp]


@dataclasses.dataclass
class While:
    """Repeat ``items`` while classical bit (or whole register when clbit
    is None) equals ``value``; executed shot-batched with per-shot masks,
    at most ``max_iter`` iterations."""
    clbit: Optional[int]
    value: int
    items: List[object]  # GateOp | Measure | Cond | While
    max_iter: int = WHILE_MAX_ITERATIONS


@dataclasses.dataclass
class Switch:
    """OpenQASM 3 ``switch (c) { case v, ... { } default { } }``: the
    first case whose value list contains the register (or single bit when
    ``clbit`` is set) value runs; ``default`` (may be empty) catches the
    rest. Executed shot-batched: every arm runs once with the mask of
    shots it matched."""
    clbit: Optional[int]
    cases: List[Tuple[Tuple[int, ...], List[object]]]
    default: List[object]


@dataclasses.dataclass
class GateDef:
    params: List[str]
    qargs: List[str]
    body: List[Tuple[str, List[str], List[str]]]  # (name, param_exprs, args)


@dataclasses.dataclass
class SubDef:
    """An OpenQASM 3 ``def`` subroutine: typed args (kind "q" for qubit,
    "c" for classical) + raw body statements, expanded at call sites.
    ``returns`` marks a ``-> bit`` subroutine whose body ends with
    ``return measure <qubit>;`` — the call site must capture it
    (``c[k] = name(...);``), and the return lowers to a measurement into
    that classical bit."""
    args: List[Tuple[str, str]]  # (kind, name)
    body: List[str]
    returns: bool = False


@dataclasses.dataclass
class DynamicProgram:
    num_qubits: int
    num_clbits: int
    items: List[object]  # GateOp | Measure | Cond
    measure_all: bool = False

    @property
    def is_static(self) -> bool:
        return all(isinstance(it, GateOp) for it in self.items)

    def to_ir(self) -> CircuitIR:
        if not self.is_static:
            raise ValueError(
                "program uses measurement/classical control, which this "
                "package does not execute yet (ROADMAP Queue 1 item 9)")
        ir = CircuitIR(self.num_qubits, name="from_qasm")
        ir.ops.extend(self.items)
        return ir


def _qubits_in(arg_text: str, env: Dict[str, float]) -> List[int]:
    """Qubit indices referenced as q[expr] — expressions may use loop
    variables and arithmetic (evaluated against ``env``)."""
    out = []
    for expr in re.findall(r"q\[([^\]]+)\]", arg_text):
        val = _eval_param(expr, env)
        if abs(val - round(val)) > 1e-9:
            raise ValueError(f"qubit index {expr!r} is not an integer")
        out.append(int(round(val)))
    return out


def _split_gate_stmt(s: str):
    """(name, params_text or None, args_text) for a gate-application
    statement, or None if ``s`` is not shaped like one. The parameter list
    is extracted with a balanced-parenthesis scan so expressions like
    ``rz(pi/(1+1))`` parse whole (a regex ``[^)]*`` truncates them)."""
    m = re.match(r"^(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)\s*", s)
    if not m:
        return None
    name = m.group("name")
    rest = s[m.end():]
    params = None
    if rest.startswith("("):
        try:
            end = _scan_paren(rest, 0)
        except ValueError:
            return None
        params = rest[1:end - 1]
        rest = rest[end:].lstrip()
    m2 = re.match(r"^(?P<args>\S.*?)\s*;$", rest)
    if not m2:
        return None
    return name, params, m2.group("args")


def _split_commas(s: str) -> List[str]:
    """Split a parameter list on top-level commas only."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
            continue
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        cur.append(ch)
    out.append("".join(cur))
    return out


def _scan_paren(s: str, start: int) -> int:
    """Index just past the ')' matching the '(' at ``start``; supports
    nesting (so ``pow(2*(1+1))`` / ``rz(pi/(1+1))`` parse whole)."""
    depth = 0
    for i in range(start, len(s)):
        if s[i] == "(":
            depth += 1
        elif s[i] == ")":
            depth -= 1
            if depth == 0:
                return i + 1
    raise ValueError(f"unbalanced parentheses in {s!r}")


def _match_modifier(rest: str):
    """Match one leading gate modifier (``inv @``, ``pow(EXPR) @``,
    ``ctrl(n) @``, ``negctrl @``); returns (mod-dict, remainder) or None.
    pow exponents are scanned with balanced parentheses, not a regex."""
    s = rest.lstrip()
    m = re.match(r"^(?P<neg>neg)?ctrl(?:\((?P<n>\d+)\))?\s*@\s*", s)
    if m:
        return ({"mod": "ctrl", "neg": bool(m.group("neg")),
                 "n": int(m.group("n") or 1)}, s[m.end():])
    m = re.match(r"^inv\s*@\s*", s)
    if m:
        return {"mod": "inv"}, s[m.end():]
    m = re.match(r"^pow\s*\(", s)
    if m:
        end = _scan_paren(s, m.end() - 1)
        after = re.match(r"\s*@\s*", s[end:])
        if after:
            return ({"mod": "pow", "exp": s[m.end():end - 1]},
                    s[end + after.end():])
    return None


def _parse_gate_use(line: str, macros: Dict[str, GateDef],
                    env: Dict[str, float]) -> Optional[List[GateOp]]:
    """Parse one gate-application statement into GateOps (macro uses are
    expanded recursively). OpenQASM 3 gate modifiers — ``inv @``,
    ``pow(k) @`` (integer k), ``ctrl(n) @``, ``negctrl @`` — compose:
    controls prepend to the qubit argument list (modifier order), inv
    daggers the reversed body, pow repeats it."""
    mods = []
    rest = line
    while True:
        hit = _match_modifier(rest)
        if hit is None:
            break
        mm, rest = hit
        mods.append(mm)
    if mods:
        ctrl_specs = []  # (negated?) per control qubit slot, in order
        inv = False
        power = 1
        for mm in mods:
            tok = mm["mod"]
            if tok == "inv":
                inv = not inv
            elif tok == "pow":
                k = _eval_param(mm["exp"], env)
                if abs(k - round(k)) > 1e-9:
                    raise ValueError(
                        f"only integer pow modifiers supported: {line!r}")
                power *= int(round(k))
            else:
                ctrl_specs.extend([mm["neg"]] * mm["n"])
        qubits = _qubits_in(line, env)
        nc = len(ctrl_specs)
        if len(qubits) < nc + 1:
            raise ValueError(f"not enough qubits for modifiers: {line!r}")
        controls, own = qubits[:nc], qubits[nc:]
        # rebuild the base statement with only the gate's own qubits
        nm = re.match(r"^\s*(?P<name>\w+)\s*", rest)
        if nm is None:
            raise ValueError(f"cannot parse modified gate: {line!r}")
        base_name = nm.group("name")
        after = rest[nm.end():]
        if after.startswith("("):
            params_txt = after[:_scan_paren(after, 0)]
        else:
            params_txt = ""
        base_line = (f"{base_name}{params_txt} "
                     + ", ".join(f"q[{q}]" for q in own) + ";")
        ops = _parse_gate_use(base_line, macros, env)
        if ops is None:
            raise ValueError(f"cannot parse modified gate: {line!r}")
        if power < 0:
            inv, power = not inv, -power
        if inv:
            ops = [dataclasses.replace(op, is_adjoint=not op.is_adjoint)
                   for op in reversed(ops)]
        out: List[GateOp] = []
        neg = [q for q, is_neg in zip(controls, ctrl_specs) if is_neg]
        for _ in range(power):
            for q in neg:  # negctrl = X-conjugated control
                out.append(GateOp("X", (q,)))
            out.extend(
                dataclasses.replace(op,
                                    controls=tuple(controls) + op.controls)
                for op in ops)
            for q in neg:
                out.append(GateOp("X", (q,)))
        return out
    m = _CTRL_RE.match(line)
    if m:
        qubits = _qubits_in(m.group("args"), env)
        if m.group("name") != "x":
            raise ValueError(f"unsupported controlled gate: {line!r}")
        return [GateOp("MCX", tuple(qubits[-1:]), tuple(qubits[:-1]), ())]
    parts = _split_gate_stmt(line)
    if parts is None:
        return None
    name, params_text, arg_text = parts
    name = name.lower()
    qubits = _qubits_in(arg_text, env)
    param_exprs = _split_commas(params_text) if params_text else []
    if name in macros:
        macro = macros[name]
        if len(param_exprs) != len(macro.params):
            raise ValueError(f"{name} expects {len(macro.params)} params")
        if len(qubits) != len(macro.qargs):
            raise ValueError(f"{name} expects {len(macro.qargs)} qubits")
        local = {p: _eval_param(e, env)
                 for p, e in zip(macro.params, param_exprs)}
        qmap = dict(zip(macro.qargs, qubits))
        out: List[GateOp] = []
        for bname, bparams, bargs in macro.body:
            sub_args = ", ".join(f"q[{qmap[a]}]" for a in bargs)
            sub_params = f"({', '.join(bparams)})" if bparams else ""
            sub_line = f"{bname}{sub_params} {sub_args};"
            sub = _parse_gate_use(sub_line, macros, local)
            if sub is None:
                raise ValueError(f"cannot parse macro body line {sub_line!r}")
            out.extend(sub)
        return out
    params = [_eval_param(p, env) for p in param_exprs]
    if name in _CTRL_MAP:
        base, nc = _CTRL_MAP[name]
        return [GateOp(base, tuple(qubits[nc:]), tuple(qubits[:nc]),
                       tuple(params))]
    if name in _NAME_MAP:
        base, ntgt, npar = _NAME_MAP[name]
        if len(params) != npar:
            raise ValueError(f"{name} expects {npar} params: {line!r}")
        return [GateOp(base, tuple(qubits), (), tuple(params))]
    raise ValueError(f"unknown gate in QASM: {line!r}")


def _split_statements(text: str) -> List[str]:
    """Normalize to one statement (or block header/footer) per element:
    statements end at ';', blocks open at '{' and close at '}' — all of
    which may share a source line."""
    out = []
    for raw in text.splitlines():
        line = raw.split("//")[0]
        # keep ';' with its statement and '{' with its header; '}' alone
        line = line.replace(";", ";\n").replace("{", "{\n")
        line = line.replace("}", "\n}\n")
        for piece in line.splitlines():
            piece = piece.strip()
            if piece:
                out.append(piece)
    return out


def _parse_gatedef_body(lines: List[str], start: int):
    """Collect a gate definition's body until the closing brace."""
    body: List[Tuple[str, List[str], List[str]]] = []
    i = start
    while i < len(lines):
        line = lines[i]
        if line.startswith("}"):
            return body, i + 1
        parts = _split_gate_stmt(line)
        if parts is None:
            raise ValueError(f"cannot parse gate-definition line: {line!r}")
        gname, params_text, args_text = parts
        params = ([p.strip() for p in _split_commas(params_text)]
                  if params_text else [])
        args = [a.strip() for a in args_text.split(",")]
        body.append((gname.lower(), params, args))
        i += 1
    raise ValueError("unterminated gate definition")


def _collect_block(lines: List[str], start: int) -> Tuple[List[str], int]:
    """Collect statements until the matching '}' (nested blocks kept
    verbatim for recursive parsing)."""
    body: List[str] = []
    depth = 1
    i = start
    while i < len(lines):
        ln = lines[i]
        i += 1
        depth += ln.count("{") - ln.count("}")
        if depth == 0:
            return body, i
        body.append(ln)
    raise ValueError("unterminated block")


def _eval_range(expr: str, env: Dict[str, float]) -> List[int]:
    """OpenQASM 3 range [start:stop] / [start:step:stop], stop INCLUSIVE."""
    parts = [(_eval_param(p, env)) for p in expr.split(":")]
    if len(parts) == 2:
        start, step, stop = parts[0], 1.0, parts[1]
    elif len(parts) == 3:
        start, step, stop = parts
    else:
        raise ValueError(f"bad range expression: {expr!r}")
    start, step, stop = int(start), int(step), int(stop)
    if step == 0:
        raise ValueError("range step cannot be 0")
    return list(range(start, stop + (1 if step > 0 else -1), step))


class _ProgState:
    def __init__(self):
        self.num_qubits: Optional[int] = None
        self.num_clbits = 0
        self.measure_all = False
        self.macros: Dict[str, GateDef] = {}
        self.defs: Dict[str, SubDef] = {}
        self.items: List[object] = []


def _parse_def_args(text: str) -> List[Tuple[str, str]]:
    """Typed subroutine arg list -> [(kind, name)]: "qubit a" -> ("q", "a"),
    classical decls (int/uint/float/angle/bit, optional width) -> ("c", name).
    """
    out: List[Tuple[str, str]] = []
    for decl in text.split(","):
        decl = decl.strip()
        if not decl:
            continue
        toks = decl.replace("const ", "").split()
        if len(toks) < 2:
            raise ValueError(f"cannot parse subroutine arg: {decl!r}")
        kind = "q" if toks[0].startswith("qubit") else "c"
        out.append((kind, toks[-1]))
    return out


def _expand_def_call(sub: SubDef, name: str, args_text: str, st: _ProgState,
                     env: Dict[str, float],
                     ret_clbit: Optional[int] = None) -> None:
    """Inline a ``def`` call: bind classical args into the environment,
    substitute qubit formals with ``q[idx]`` tokens, rewrite a trailing
    ``return measure <qubit>;`` into a measurement targeting ``ret_clbit``,
    then parse the expanded body in place."""
    call_args = [a.strip() for a in args_text.split(",") if a.strip()]
    if len(call_args) != len(sub.args):
        raise ValueError(f"{name} expects {len(sub.args)} args, got "
                         f"{len(call_args)}")
    sub_env = dict(env)
    qmap: Dict[str, int] = {}
    for (kind, formal), actual in zip(sub.args, call_args):
        if kind == "q":
            qs = _qubits_in(actual, env)
            if len(qs) != 1:
                raise ValueError(
                    f"subroutine qubit arg must be one q[i]: {actual!r}")
            qmap[formal] = qs[0]
        else:
            sub_env[formal] = _eval_param(actual, env)
    body = []
    for ln in sub.body:
        for formal, idx in qmap.items():
            ln = re.sub(rf"\b{re.escape(formal)}\b", f"q[{idx}]", ln)
        rm = _RETURN_RE.match(ln)
        if rm is not None:
            if ret_clbit is None:
                raise ValueError(f"{name}: 'return' outside a captured call")
            ln = f"c[{ret_clbit}] = measure {rm.group('q')};"
        body.append(ln)
    _parse_stmts(body, st, sub_env)


def _parse_stmts(lines: List[str], st: _ProgState,
                 env: Dict[str, float]) -> None:
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if line.startswith(("OPENQASM", "include", "barrier")):
            continue
        m = _CREG_RE.match(line)
        if m:
            st.num_clbits = int(m.group(1) or m.group(2))
            continue
        if line.startswith(("c = measure", "c=measure")) or \
                re.match(r"^measure\s+q\s*->\s*c\s*;$", line):
            st.measure_all = True
            continue
        m = _QREG_RE.match(line) or _QREG2_RE.match(line)
        if m:
            st.num_qubits = int(m.group(1))
            continue
        m = _GATEDEF_RE.match(line)
        if m:
            params = ([p.strip() for p in m.group("params").split(",")]
                      if m.group("params") else [])
            qargs = [a.strip() for a in m.group("args").split(",")]
            rest = line[line.index("{") + 1:].strip()
            if rest:
                lines.insert(i, rest)
            body, i = _parse_gatedef_body(lines, i)
            st.macros[m.group("name").lower()] = GateDef(params, qargs, body)
            continue
        m = _FOR_RE.match(line)
        if m:
            body, i = _collect_block(lines, i)
            var = m.group("var")
            for val in _eval_range(m.group("range"), env):
                sub_env = dict(env)
                sub_env[var] = float(val)
                _parse_stmts(list(body), st, sub_env)
            continue
        m = _DEF_RE.match(line)
        if m:
            rest = line[line.index("{") + 1:].strip()
            if rest:
                lines.insert(i, rest)
            body, i = _collect_block(lines, i)
            returns = m.group("ret") is not None
            if returns and not (body and _RETURN_RE.match(body[-1])):
                raise ValueError(
                    f"def {m.group('name')} declares a return type but its "
                    "body does not end with 'return measure <qubit>;'")
            st.defs[m.group("name").lower()] = SubDef(
                _parse_def_args(m.group("args")), body, returns=returns)
            continue
        m = _SWITCH_RE.match(line)
        if m:
            body, i = _collect_block(lines, i)
            bit = int(m.group("bit")) if m.group("bit") is not None else None
            cases: List[Tuple[Tuple[int, ...], List[object]]] = []
            default: List[object] = []
            j = 0
            while j < len(body):
                hdr = body[j]
                j += 1
                cm = _CASE_RE.match(hdr)
                dm = _DEFAULT_RE.match(hdr) if cm is None else None
                if cm is None and dm is None:
                    raise ValueError(
                        f"expected 'case <values> {{' or 'default {{' in "
                        f"switch, got {hdr!r}")
                arm, j = _collect_block(body, j)
                saved = st.items
                st.items = []
                _parse_stmts(list(arm), st, env)
                arm_items, st.items = st.items, saved
                if cm is not None:
                    vals = tuple(int(v) for v in cm.group("vals").split(","))
                    cases.append((vals, arm_items))
                else:
                    default = arm_items
            st.items.append(Switch(bit, cases, default))
            continue
        m = _WHILE_RE.match(line)
        if m:
            rest = line[line.index("{") + 1:].strip()
            if rest:
                lines.insert(i, rest)
            body, i = _collect_block(lines, i)
            bit = int(m.group("bit")) if m.group("bit") is not None else None
            saved = st.items
            st.items = []
            _parse_stmts(list(body), st, env)
            body_items, st.items = st.items, saved
            st.items.append(While(bit, int(m.group("val")), body_items))
            continue
        m = _MEAS3_RE.match(line) or _MEAS2_RE.match(line)
        if m:
            q = int(_eval_param(m.group("q"), env))
            c = int(_eval_param(m.group("c"), env))
            st.num_clbits = max(st.num_clbits, c + 1)
            st.items.append(Measure(q, c))
            continue
        m = _IF_RE.match(line)
        if m:
            bit = int(m.group("bit")) if m.group("bit") is not None else None
            value = int(m.group("val"))
            rest = m.group("rest").strip()
            cond_ops: List[GateOp] = []
            if rest.startswith("{"):
                rest = rest[1:].strip()
                if rest and rest != "}":
                    lines.insert(i, rest)
                block, i = _collect_block(lines, i)
                for ln in block:
                    ops = _parse_gate_use(ln, st.macros, env)
                    if ops is None:
                        raise ValueError(f"cannot parse if-block line {ln!r}")
                    cond_ops.extend(ops)
            else:
                ops = _parse_gate_use(rest, st.macros, env)
                if ops is None:
                    raise ValueError(f"cannot parse conditional {rest!r}")
                cond_ops.extend(ops)
            st.items.append(Cond(bit, value, cond_ops))
            continue
        m = _DEFRETCALL_RE.match(line)
        if m and m.group("name").lower() in st.defs:
            sub = st.defs[m.group("name").lower()]
            if not sub.returns:
                raise ValueError(
                    f"{m.group('name')} has no return value to assign")
            dest = int(_eval_param(m.group("c"), env))
            st.num_clbits = max(st.num_clbits, dest + 1)
            _expand_def_call(sub, m.group("name"), m.group("args"), st, env,
                             ret_clbit=dest)
            continue
        m = _DEFCALL_RE.match(line)
        if m and m.group("name").lower() in st.defs:
            sub = st.defs[m.group("name").lower()]
            if sub.returns:
                raise ValueError(
                    f"{m.group('name')} returns a bit; capture it with "
                    f"'c[k] = {m.group('name')}(...);'")
            _expand_def_call(sub, m.group("name"), m.group("args"), st, env)
            continue
        ops = _parse_gate_use(line, st.macros, env)
        if ops is not None:
            st.items.extend(ops)
            continue
        raise ValueError(f"cannot parse QASM line: {line!r}")


def parse_qasm3_program(text: str) -> DynamicProgram:
    st = _ProgState()
    _parse_stmts(_split_statements(text), st, {})
    if st.num_qubits is None:
        raise ValueError("QASM has no qubit register declaration")
    return DynamicProgram(st.num_qubits, st.num_clbits, st.items,
                          st.measure_all)


def parse_qasm3(text: str) -> CircuitIR:
    """Static-circuit entry point (original contract): returns a CircuitIR,
    raising on measurement/classical-control constructs."""
    return parse_qasm3_program(text).to_ir()
