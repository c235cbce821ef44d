"""SELECT ... FROM ... WHERE ... over JSON documents.

The JAX package's ``query/json_query.py`` (reference
weed/query/json/query_json.go and weed/query/sqltypes/, the volume
server's S3-Select-style ``Query``, volume_grpc_query.go:12): a needle
holds JSON documents, one a line (or one document, or a top-level
array); a query projects fields (dotted paths) and filters rows. The
grammar, the reference's subset:

    SELECT * | field[,field...] FROM <anything>
        [WHERE <cond> [AND|OR <cond>]...]
    cond := path (=|!=|<|<=|>|>=) literal
    literal := 'string' | "string" | number | true | false | null

Conditions join left to right, without precedence; a projected field a
document lacks is left out of its row, keyed by the path's last part.
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable, Dict, List, Optional


class QueryError(Exception):
    pass


_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*") |
        (?P<num>-?\d+(?:\.\d+)?) |
        (?P<op><=|>=|!=|=|<|>) |
        (?P<word>[A-Za-z_][\w.*]*|\*) |
        (?P<comma>,)
    )""", re.VERBOSE)


def _tokenize(s: str) -> List[tuple]:
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if m is None:
            if s[pos:].strip() == "":
                break
            raise QueryError(f"bad token at {s[pos:pos + 20]!r}")
        pos = m.end()
        for kind in ("str", "num", "op", "word", "comma"):
            if m.group(kind) is not None:
                out.append((kind, m.group(kind)))
                break
    return out


def _get_path(doc: Any, path: str):
    cur = doc
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return None
    return cur


def _literal(kind: str, text: str):
    if kind == "str":
        return text[1:-1].replace("\\'", "'").replace('\\"', '"')
    if kind == "num":
        return float(text) if "." in text else int(text)
    low = text.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low == "null":
        return None
    raise QueryError(f"bad literal {text!r}")


_OPS: Dict[str, Callable[[Any, Any], bool]] = {
    "=": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a is not None and b is not None and a < b,
    "<=": lambda a, b: a is not None and b is not None and a <= b,
    ">": lambda a, b: a is not None and b is not None and a > b,
    ">=": lambda a, b: a is not None and b is not None and a >= b,
}


class Query:
    def __init__(self, projections: List[str], where):
        self.projections = projections      # ["*"] or dotted paths
        self.where = where                  # None or predicate(doc)

    def match(self, doc) -> bool:
        return self.where is None or self.where(doc)

    def project(self, doc):
        if self.projections == ["*"]:
            return doc
        out = {}
        for p in self.projections:
            v = _get_path(doc, p)
            if v is not None:
                # nested output keyed by the last path segment,
                # matching the reference's flattened projection
                out[p.split(".")[-1]] = v
        return out


def parse_query(sql: str) -> Query:
    toks = _tokenize(sql)
    i = 0

    def expect_word(word: str):
        nonlocal i
        if i >= len(toks) or toks[i][0] != "word" or \
                toks[i][1].upper() != word:
            raise QueryError(f"expected {word}")
        i += 1

    expect_word("SELECT")
    projections: List[str] = []
    while i < len(toks):
        kind, text = toks[i]
        if kind == "word" and text.upper() == "FROM":
            break
        if kind == "word":
            projections.append(text)
            i += 1
        elif kind == "comma":
            i += 1
        else:
            raise QueryError(f"bad projection {text!r}")
    if not projections:
        raise QueryError("no projections")
    if "*" in projections:
        projections = ["*"]
    expect_word("FROM")
    if i < len(toks) and toks[i][0] == "word":
        i += 1                              # table name is decorative
    where = None
    if i < len(toks):
        expect_word("WHERE")
        conds: List[tuple] = []             # (joiner, pred)
        joiner = None
        while i < len(toks):
            if toks[i][0] != "word":
                raise QueryError("expected field path")
            path = toks[i][1]
            i += 1
            if i >= len(toks) or toks[i][0] != "op":
                raise QueryError("expected comparison operator")
            op = _OPS[toks[i][1]]
            i += 1
            if i >= len(toks) or toks[i][0] not in ("str", "num",
                                                    "word"):
                raise QueryError("expected literal")
            lit = _literal(toks[i][0], toks[i][1])
            i += 1
            conds.append((joiner,
                          lambda d, p=path, o=op, v=lit:
                          o(_get_path(d, p), v)))
            if i < len(toks) and toks[i][0] == "word" and \
                    toks[i][1].upper() in ("AND", "OR"):
                joiner = toks[i][1].upper()
                i += 1
            else:
                break
        if not conds:
            raise QueryError("empty WHERE clause")
        if i < len(toks):
            raise QueryError(f"trailing tokens at {toks[i][1]!r}")

        def predicate(doc) -> bool:
            result = conds[0][1](doc)
            for join, pred in conds[1:]:
                if join == "AND":
                    result = result and pred(doc)
                else:
                    result = result or pred(doc)
            return result
        where = predicate
    return Query(projections, where)


def query_json_lines(data: bytes, sql: str,
                     limit: int = 0) -> List[dict]:
    """Run a query over newline-delimited JSON documents (or a single
    JSON document / top-level array). Returns projected rows."""
    q = parse_query(sql)
    rows: List[dict] = []
    text = data.decode("utf-8", "replace").strip()
    docs = []
    if text.startswith("["):
        try:
            docs = json.loads(text)
        except ValueError as e:
            raise QueryError(f"bad JSON array: {e}") from None
    else:
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                docs.append(json.loads(line))
            except ValueError:
                continue                    # skip non-JSON lines
    for doc in docs:
        if q.match(doc):
            rows.append(q.project(doc))
            if limit and len(rows) >= limit:
                break
    return rows
