"""PG SQL lexer + token-level dialect translation.

The reference parses PG SQL with a real parser (sqlparser — corro-pg/src/
lib.rs:306, 325-327) before rewriting it for SQLite. The regex passes this
module replaces were blind to comments and could be confused by quoted
text; here a small hand-written lexer produces a token stream —
strings/identifiers/comments/dollar-quotes/parameters are single tokens —
and every translation (session shims, boolean/ILIKE dialect, ``::`` casts,
E-string decoding, ``$N`` placeholders, pg_catalog routing, statement
splitting) walks tokens, so content inside literals and comments can never
be rewritten or mis-split.

Lexical grammar follows PostgreSQL's: ``--`` line comments, nested
``/* */`` block comments, ``'...'`` strings with doubled-quote escapes,
``E'...'`` strings with backslash escapes, ``$tag$...$tag$`` dollar
quoting, ``"..."`` identifiers, ``$N`` parameters, and ``::`` as a single
operator token. Counterpart of corrosion_tpu/agent/pgsql.py.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

__all__ = [
    "Tok", "tokenize", "render", "split_statements", "translate",
    "translate_placeholders", "strip_catalog_prefix", "mentions_catalog",
]


@dataclass
class Tok:
    kind: str  # ws comment str estr qident ident num param op
    text: str


_IDENT_START = set("abcdefghijklmnopqrstuvwxyz" "ABCDEFGHIJKLMNOPQRSTUVWXYZ_")
_IDENT_CONT = _IDENT_START | set("0123456789$")
_DOLLAR_TAG = re.compile(r"\$(?:[A-Za-z_][A-Za-z_0-9]*)?\$")


def tokenize(sql: str) -> list[Tok]:
    toks: list[Tok] = []
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        # Whitespace runs.
        if ch.isspace():
            j = i + 1
            while j < n and sql[j].isspace():
                j += 1
            toks.append(Tok("ws", sql[i:j]))
            i = j
            continue
        # Line comment.
        if ch == "-" and sql.startswith("--", i):
            j = sql.find("\n", i)
            j = n if j < 0 else j + 1
            toks.append(Tok("comment", sql[i:j]))
            i = j
            continue
        # Block comment (nested, per PG).
        if ch == "/" and sql.startswith("/*", i):
            depth = 1
            j = i + 2
            while j < n and depth:
                if sql.startswith("/*", j):
                    depth += 1
                    j += 2
                elif sql.startswith("*/", j):
                    depth -= 1
                    j += 2
                else:
                    j += 1
            toks.append(Tok("comment", sql[i:j]))
            i = j
            continue
        # Standard string literal; doubled quotes stay inside ONE token.
        if ch == "'":
            toks.append(Tok("str", sql[i:(i := _scan_quoted(sql, i, "'"))]))
            continue
        # Quoted identifier.
        if ch == '"':
            toks.append(Tok("qident", sql[i:(i := _scan_quoted(sql, i, '"'))]))
            continue
        # Dollar-quoted string or $N parameter.
        if ch == "$":
            m = _DOLLAR_TAG.match(sql, i)
            if m:
                tag = m.group(0)
                close = sql.find(tag, m.end())
                j = n if close < 0 else close + len(tag)
                toks.append(Tok("str", sql[i:j]))
                i = j
                continue
            m = re.match(r"\$\d+", sql[i:])
            if m:
                toks.append(Tok("param", m.group(0)))
                i += m.end()
                continue
            toks.append(Tok("op", "$"))
            i += 1
            continue
        # SQLite-style ?N placeholder: translate_placeholders runs BEFORE
        # translate in the prepared-statement path, so the cast pass must
        # see ?N as a single parameter token ("$1::int8" → "?1::int8" →
        # CAST(?1 AS INTEGER)).
        if ch == "?":
            m = re.match(r"\?\d*", sql[i:])
            toks.append(Tok("param", m.group(0)))
            i += m.end()
            continue
        # E'...' escape string / identifier / keyword.
        if ch in _IDENT_START:
            if ch in "eE" and i + 1 < n and sql[i + 1] == "'":
                j = _scan_estring(sql, i + 1)
                toks.append(Tok("estr", sql[i:j]))
                i = j
                continue
            j = i + 1
            while j < n and sql[j] in _IDENT_CONT:
                j += 1
            toks.append(Tok("ident", sql[i:j]))
            i = j
            continue
        # Number (digits, decimal point, exponent).
        if ch.isdigit() or (
            ch == "." and i + 1 < n and sql[i + 1].isdigit()
        ):
            j = i
            while j < n and (sql[j].isdigit() or sql[j] == "."):
                j += 1
            if j < n and sql[j] in "eE":
                k = j + 1
                if k < n and sql[k] in "+-":
                    k += 1
                if k < n and sql[k].isdigit():
                    j = k
                    while j < n and sql[j].isdigit():
                        j += 1
            toks.append(Tok("num", sql[i:j]))
            i = j
            continue
        # '::' is one operator token; everything else single chars.
        if ch == ":" and sql.startswith("::", i):
            toks.append(Tok("op", "::"))
            i += 2
            continue
        toks.append(Tok("op", ch))
        i += 1
    return toks


def _scan_quoted(sql: str, i: int, q: str) -> int:
    """Scan a quoted run starting at ``i``; doubled quotes continue it."""
    n = len(sql)
    j = i + 1
    while j < n:
        if sql[j] == q:
            if j + 1 < n and sql[j + 1] == q:
                j += 2
                continue
            return j + 1
        j += 1
    return n


def _scan_estring(sql: str, i: int) -> int:
    """Scan the quoted body of an E-string (backslash escapes)."""
    n = len(sql)
    j = i + 1
    while j < n:
        if sql[j] == "\\" and j + 1 < n:
            j += 2
            continue
        if sql[j] == "'":
            if j + 1 < n and sql[j + 1] == "'":
                j += 2
                continue
            return j + 1
        j += 1
    return n


def render(toks: list[Tok]) -> str:
    return "".join(t.text for t in toks)


def split_statements(sql: str) -> list[str]:
    """Top-level ';' split — token-aware, so ';' inside strings, quoted
    identifiers, comments, and dollar-quoted blocks never splits."""
    parts: list[list[Tok]] = [[]]
    for t in tokenize(sql):
        if t.kind == "op" and t.text == ";":
            parts.append([])
        else:
            parts[-1].append(t)
    out = []
    for p in parts:
        s = render(p).strip()
        if s:
            out.append(s)
    return out


# -- translation passes -------------------------------------------------------

# PG type name → SQLite CAST target (affinity groups).
PG_TYPE_MAP = {
    "int2": "INTEGER", "int4": "INTEGER", "int8": "INTEGER",
    "smallint": "INTEGER", "integer": "INTEGER", "int": "INTEGER",
    "bigint": "INTEGER", "serial": "INTEGER", "bigserial": "INTEGER",
    "oid": "INTEGER", "bool": "INTEGER", "boolean": "INTEGER",
    "float4": "REAL", "float8": "REAL", "real": "REAL",
    "numeric": "REAL", "decimal": "REAL", "double": "REAL",
    "text": "TEXT", "varchar": "TEXT", "char": "TEXT", "bpchar": "TEXT",
    "character": "TEXT",
    "name": "TEXT", "uuid": "TEXT", "json": "TEXT", "jsonb": "TEXT",
    "regclass": "TEXT", "regtype": "TEXT",
    "bytea": "BLOB",
}

_SESSION_FN = {
    "version": "'corrosion-tpu (PostgreSQL 14 compatible)'",
    "current_database": "'corrosion'",
    "current_schema": "'public'",
    "pg_backend_pid": "1",
}
_SESSION_IDENT = {
    "current_user": "'corrosion'",
    "session_user": "'corrosion'",
}
_DIALECT_IDENT = {"true": "1", "false": "0", "ilike": "LIKE"}

_ESCAPES = {
    "n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f",
    "\\": "\\", "'": "'", '"': '"',
}


def _sig(toks: list[Tok], i: int, step: int) -> int:
    """Next significant (non-ws/comment) token index from i+step, or -1."""
    j = i + step
    while 0 <= j < len(toks):
        if toks[j].kind not in ("ws", "comment"):
            return j
        j += step
    return -1


def _pass_idents(toks: list[Tok]) -> list[Tok]:
    """Session shims + boolean/ILIKE dialect, on identifier tokens only."""
    out = list(toks)
    for i, t in enumerate(out):
        if t.kind != "ident":
            continue
        low = t.text.lower()
        if low in _SESSION_FN:
            j = _sig(out, i, 1)
            if j >= 0 and out[j].text == "(":
                k = _sig(out, j, 1)
                if k >= 0 and out[k].text == ")":
                    out[i] = Tok("num", _SESSION_FN[low])
                    for idx in range(i + 1, k + 1):
                        out[idx] = Tok("ws", "")
            continue
        if low in _SESSION_IDENT:
            # Not a column reference when qualified (t.current_user).
            p = _sig(out, i, -1)
            if p >= 0 and out[p].text == ".":
                continue
            out[i] = Tok("str", _SESSION_IDENT[low])
            continue
        if low in _DIALECT_IDENT:
            p = _sig(out, i, -1)
            if p >= 0 and out[p].text == ".":
                continue
            out[i] = Tok(t.kind, _DIALECT_IDENT[low])
    return [t for t in out if t.text != ""]


def _pass_estrings(toks: list[Tok]) -> list[Tok]:
    """E'...' → standard literal with escapes decoded (SQLite has no
    backslash escapes)."""
    out = []
    for t in toks:
        if t.kind != "estr":
            out.append(t)
            continue
        body = t.text[2:-1] if t.text.endswith("'") else t.text[2:]
        decoded = []
        j = 0
        while j < len(body):
            if body[j] == "\\" and j + 1 < len(body):
                decoded.append(_ESCAPES.get(body[j + 1], body[j + 1]))
                j += 2
            elif body[j] == "'" and j + 1 < len(body) and body[j + 1] == "'":
                decoded.append("'")
                j += 2
            else:
                decoded.append(body[j])
                j += 1
        out.append(Tok("str", "'" + "".join(decoded).replace("'", "''") + "'"))
    return out


_VALUE_KINDS = {"str", "estr", "qident", "ident", "num", "param"}

# Reserved words that can precede '(' without being a function call — a
# parenthesized cast value must not swallow them.
_RESERVED = {
    "select", "from", "where", "and", "or", "not", "in", "as", "on", "by",
    "group", "order", "limit", "offset", "join", "inner", "left", "right",
    "full", "cross", "outer", "values", "set", "case", "when", "then",
    "else", "end", "distinct", "all", "union", "except", "intersect",
    "having", "insert", "update", "delete", "returning", "like", "ilike",
    "between", "is", "null", "exists", "any", "some", "using", "into",
}


def _value_span(toks: list[Tok], end: int) -> int:
    """Start index of the value expression ending at ``end`` (inclusive):
    a parenthesized run (plus a preceding function name), or a dotted
    identifier chain, or a single value token."""
    t = toks[end]
    if t.text == ")":
        depth = 0
        j = end
        while j >= 0:
            if toks[j].text == ")":
                depth += 1
            elif toks[j].text == "(":
                depth -= 1
                if depth == 0:
                    break
            j -= 1
        if j < 0:
            return end
        p = _sig(toks, j, -1)
        # f(x)::t casts the call result; CAST(...) from a previous pass
        # keeps its keyword attached the same way. Reserved words before
        # '(' are clause keywords, not callables.
        if p >= 0 and toks[p].kind in ("ident", "qident") and (
            toks[p].text.lower() not in _RESERVED
        ):
            return p
        return j
    if t.text == "]":
        # Bracketed run: ARRAY[...] literal or a subscripted value x[i] —
        # include the matching '[' and the value it subscripts (a bare ']'
        # treated as a one-token value mangled ARRAY casts).
        depth = 0
        j = end
        while j >= 0:
            if toks[j].text == "]":
                depth += 1
            elif toks[j].text == "[":
                depth -= 1
                if depth == 0:
                    break
            j -= 1
        if j < 0:
            return end
        p = _sig(toks, j, -1)
        if p >= 0 and (
            toks[p].text in (")", "]") or toks[p].kind in _VALUE_KINDS
        ) and not (
            toks[p].kind in ("ident", "qident")
            and toks[p].text.lower() in _RESERVED
        ):
            return _value_span(toks, p)
        return j
    if t.kind in _VALUE_KINDS:
        start = end
        while True:
            p = _sig(toks, start, -1)
            if p < 0 or toks[p].text != ".":
                return start
            q = _sig(toks, p, -1)
            if q < 0 or toks[q].kind not in ("ident", "qident"):
                return start
            start = q
    return end


def _pass_casts(toks: list[Tok]) -> list[Tok]:
    """``value::type`` → ``CAST(value AS affinity)``; unknown types drop
    the cast and keep the value. Left-to-right, repeated — so nested casts
    compose: x::int::text → CAST(CAST(x AS INTEGER) AS TEXT). Terminates:
    every iteration removes one '::' (the malformed branch included)."""
    while True:
        idx = next(
            (i for i, t in enumerate(toks)
             if t.kind == "op" and t.text == "::"),
            None,
        )
        if idx is None:
            return toks
        prev = _sig(toks, idx, -1)
        nxt = _sig(toks, idx, 1)
        if prev < 0 or nxt < 0 or toks[nxt].kind != "ident":
            # Malformed; drop the operator so we can't loop forever.
            toks = toks[:idx] + toks[idx + 1:]
            continue
        type_end = nxt
        typ = toks[nxt].text.lower()
        # Multi-word type names: consume the suffix so it can never dangle
        # after the rewrite (x::double precision must not leave a bare
        # "precision" behind).
        j = _sig(toks, nxt, 1)
        if j >= 0 and toks[j].kind == "ident":
            suf = toks[j].text.lower()
            if typ == "double" and suf == "precision":
                type_end = j
            elif suf == "varying" and typ in ("character", "bit"):
                type_end = j
                typ = "varchar" if typ == "character" else "bit varying"
        # Optional length suffix: varchar(32), timestamp(3).
        j = _sig(toks, type_end, 1)
        if j >= 0 and toks[j].text == "(":
            k = _sig(toks, j, 1)
            m = _sig(toks, k, 1) if k >= 0 else -1
            if k >= 0 and toks[k].kind == "num" and m >= 0 and toks[m].text == ")":
                type_end = m
        # with/without time zone AFTER any length paren ("timestamp(3)
        # with time zone" is the common PG spelling).
        j = _sig(toks, type_end, 1)
        if (
            j >= 0 and toks[j].kind == "ident"
            and toks[j].text.lower() in ("with", "without")
            and typ in ("timestamp", "time")
        ):
            k = _sig(toks, j, 1)
            m = _sig(toks, k, 1) if k >= 0 else -1
            if (
                k >= 0 and toks[k].text.lower() == "time"
                and m >= 0 and toks[m].text.lower() == "zone"
            ):
                type_end = m
        # Array type suffix: type[] / type[n] / type[2][3] has no SQLite
        # affinity — consume ALL bracket groups and drop the cast (keep
        # the value).
        is_array_type = False
        while True:
            j = _sig(toks, type_end, 1)
            if j < 0 or toks[j].text != "[":
                break
            k = _sig(toks, j, 1)
            if k >= 0 and toks[k].text == "]":
                type_end, is_array_type = k, True
            elif k >= 0 and toks[k].kind == "num":
                m = _sig(toks, k, 1)
                if m >= 0 and toks[m].text == "]":
                    type_end, is_array_type = m, True
                else:
                    break
            else:
                break
        start = _value_span(toks, prev)
        value = toks[start:prev + 1]
        target = None if is_array_type else PG_TYPE_MAP.get(typ)
        if target is None:
            repl = value
        else:
            repl = (
                [Tok("ident", "CAST"), Tok("op", "(")]
                + value
                + [Tok("ws", " "), Tok("ident", "AS"), Tok("ws", " "),
                   Tok("ident", target), Tok("op", ")")]
            )
        toks = toks[:start] + repl + toks[type_end + 1:]


def _pass_params(toks: list[Tok]) -> list[Tok]:
    return [
        Tok("param", "?" + t.text[1:]) if t.kind == "param" else t
        for t in toks
    ]


def translate_placeholders(sql: str) -> str:
    """PG ``$N`` → SQLite ``?N`` (parameters are single tokens, so text
    inside literals/comments is untouched)."""
    return render(_pass_params(tokenize(sql)))


def strip_catalog_prefix(sql: str) -> str:
    """Drop ``pg_catalog.`` qualifiers (catalog snapshot tables are
    unqualified TEMP tables)."""
    toks = tokenize(sql)
    out: list[Tok] = []
    i = 0
    while i < len(toks):
        t = toks[i]
        if t.kind == "ident" and t.text.lower() == "pg_catalog":
            j = _sig(toks, i, 1)
            if j >= 0 and toks[j].text == ".":
                i = j + 1
                continue
        out.append(t)
        i += 1
    return render(out)


_CATALOG_TABLES = {
    "pg_type", "pg_class", "pg_namespace", "pg_database", "pg_range",
    "pg_attribute", "pg_tables",
}


def mentions_catalog(sql: str) -> bool:
    return any(
        t.kind == "ident" and t.text.lower() in _CATALOG_TABLES
        for t in tokenize(sql)
    )


def translate(sql: str) -> str:
    """Full PG → SQLite surface translation of one statement (corro-pg's
    parse_query rewrite, lib.rs:306-472): comments stripped, session shims,
    boolean/ILIKE dialect, ``::`` casts, E-strings. ``BEGIN``/``COMMIT``/
    ``SET``/``SHOW`` become empty (the agent manages transactions)."""
    # Comments become a space (not nothing: `x--c<newline>FROM` must not
    # fuse into one identifier).
    toks = [
        Tok("ws", " ") if t.kind == "comment" else t for t in tokenize(sql)
    ]
    sig = [t for t in toks if t.kind != "ws"]
    while sig and sig[-1].text == ";":
        sig.pop()
    if sig and sig[0].kind == "ident":
        head = sig[0].text.upper()
        stmt = " ".join(t.text.upper() for t in sig)
        if stmt in ("BEGIN", "COMMIT", "ROLLBACK", "START TRANSACTION"):
            return ""
        if head in ("SET", "SHOW"):
            return ""
    toks = _pass_idents(toks)
    toks = _pass_estrings(toks)
    toks = _pass_casts(toks)
    return render(toks).strip().rstrip(";").strip()
