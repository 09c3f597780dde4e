"""Small shared AST helpers for the port's blades-lint passes."""

from __future__ import annotations

import ast
from typing import List, Optional


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` as a string for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    """The dotted callee of a Call, else None (lambdas, subscripts...)."""
    return dotted(call.func)


def function_defs(nodes) -> List[ast.FunctionDef]:
    return [n for n in nodes
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
