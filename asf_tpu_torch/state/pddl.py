"""PDDL pre/post-condition ("state") model, numpy only.

Copy of ``asf_tpu/state/pddl.py`` (the port imports nothing of the JAX
package, not even its modules that import no framework): ``Predicate`` and
``Action`` with ``Action.vectorize(attributes) -> (precs_vec, posts_vec)``
over the sorted attributes with values in {-1, 0, 1}, the inverse
``Predicate.predicates_from_vector``, and ``parse_domain``/``parse_pddl``,
which ground a domain's ``:action`` operators through a small s-expression
parser for the STRIPS subset the repo's domains use (``:precondition`` and
``:effect`` with ``and``/``not`` nesting; ``pddl/domain.pddl``,
``pddl/full_domain.pddl``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple, Union

import numpy as np


@dataclass(frozen=True)
class Predicate:
    attribute: str
    value: bool

    def __str__(self) -> str:
        return ("not-" if not self.value else "") + self.attribute

    @staticmethod
    def predicates_from_vector(vector, attributes: List[str], to_str: bool = False):
        attributes = sorted(attributes)
        vector = np.asarray(vector)
        assert vector.shape == (len(attributes),), (
            f"Vector shape is {vector.shape} but should be ({len(attributes)},)"
        )
        assert np.all(np.abs(vector) <= 1), (
            f"Vector should only contain -1, 0 or 1 but contains {vector}"
        )
        predicates = []
        for i, attr in enumerate(attributes):
            if vector[i] == 1:
                predicates.append(Predicate(attribute=attr, value=True))
            elif vector[i] == -1:
                predicates.append(Predicate(attribute=attr, value=False))
        lst = sorted(predicates, key=lambda p: p.attribute)
        if to_str:
            return [str(p) for p in lst]
        return lst


@dataclass
class Action:
    name: str
    preconditions: List[Predicate] = field(default_factory=list)
    postconditions: List[Predicate] = field(default_factory=list)

    def get_all_predicates(self) -> List[Predicate]:
        return list(set(self.preconditions).union(self.postconditions))

    def vectorize(self, all_attributes: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        """+1 for a True predicate, -1 for False, 0 when absent."""
        all_attributes = sorted(all_attributes)
        pre = np.zeros(len(all_attributes), np.float32)
        post = np.zeros(len(all_attributes), np.float32)
        for p in self.preconditions:
            pre[all_attributes.index(p.attribute)] = 1 if p.value else -1
        for p in self.postconditions:
            post[all_attributes.index(p.attribute)] = 1 if p.value else -1
        return pre, post


# ---------------------------------------------------------------------------
# s-expression PDDL parsing
# ---------------------------------------------------------------------------

SExpr = Union[str, list]


def _tokenize(text: str) -> List[str]:
    out = []
    for raw_line in text.splitlines():
        line = raw_line.split(";")[0]  # strip comments
        out.extend(line.replace("(", " ( ").replace(")", " ) ").split())
    return out


def _parse_sexpr(tokens: List[str], pos: int = 0) -> Tuple[SExpr, int]:
    if tokens[pos] != "(":
        return tokens[pos], pos + 1
    pos += 1
    items: list = []
    while tokens[pos] != ")":
        node, pos = _parse_sexpr(tokens, pos)
        items.append(node)
    return items, pos + 1


def _collect_literals(expr: SExpr, negated: bool = False) -> List[Tuple[str, bool]]:
    """Flatten an (and ...)/(not ...) tree into (attribute, positive) pairs."""
    if not isinstance(expr, list) or not expr:
        return []
    head = expr[0]
    if isinstance(head, list):  # e.g. "( (and ...) )" wrapper
        out = []
        for sub in expr:
            out.extend(_collect_literals(sub, negated))
        return out
    if head == "and":
        out = []
        for sub in expr[1:]:
            out.extend(_collect_literals(sub, negated))
        return out
    if head == "not":
        return _collect_literals(expr[1], not negated)
    # a plain predicate: (name ?x ...)
    return [(head, not negated)]


def parse_domain(domain_path: str) -> Tuple[List[Action], List[str]]:
    with open(domain_path) as f:
        tokens = _tokenize(f.read())
    tree, _ = _parse_sexpr(tokens)

    actions: List[Action] = []
    attributes = set()
    for node in tree:
        if not (isinstance(node, list) and node and node[0] == ":action"):
            continue
        name = node[1]
        pre: List[Predicate] = []
        post: List[Predicate] = []
        i = 2
        while i < len(node):
            key = node[i]
            if key == ":precondition":
                for attr, positive in _collect_literals(node[i + 1]):
                    pre.append(Predicate(attribute=attr, value=positive))
                i += 2
            elif key == ":effect":
                for attr, positive in _collect_literals(node[i + 1]):
                    post.append(Predicate(attribute=attr, value=positive))
                i += 2
            else:
                i += 2  # skip :parameters etc.
        for p in pre + post:
            attributes.add(p.attribute)
        actions.append(Action(name=name, preconditions=pre, postconditions=post))
    return actions, sorted(attributes)


def parse_pddl(domain_path: str, problem_path: str = "") -> Tuple[List[Action], List[str]]:
    """The domain's actions and sorted attributes; the problem file only
    supplies grounding objects, so it is not read."""
    return parse_domain(domain_path)
