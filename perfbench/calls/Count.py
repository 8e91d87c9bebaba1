"""``Count(<expr>)``: the number of columns of a bitmap expression.

A call module gives, for a template node ``{"call": <Name>, ...}``:

- ``draw(node, d)``: the call's tree, drawn with ``d``
  (``traffic.Draw``: ``d.expr``, ``d.resolve``, ``d.at``, ``d.rng``);
  its first item is the call's name;
- ``pql(t, pql)``: the call's PQL (``pql`` writes a sub-tree);
- ``exprs(t)``: the bitmap expressions it reads, for the leaves a
  request sends;
- ``parse(result)``: the JSON result as the reference's answer is
  written;
- ``answer(ref, t, control)``: the plain reference's answer
  (``reference.Reference``), or with ``control`` the control's.

A call that makes a bitmap, for use inside an expression, gives
``words(ref, t)`` (its dense bitset) in place of ``answer``.

The control counts every slice but the last.
"""


def draw(node, d):
    return ("Count", d.at("a").expr(node["arg"]))


def pql(t, pql):
    return f"Count({pql(t[1])})"


def exprs(t):
    return [t[1]]


def parse(result):
    return result


def answer(ref, t, control=False):
    return ref.count(t[1], drop_last_slice=control)
