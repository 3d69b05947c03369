"""Pass 3: pool-invariant audit + opt-in runtime sanitizer (the reference
``analysis/poolcheck.py``).

The checkable invariant spec itself lives next to the data it guards —
``BlockAllocator.check_invariants`` and ``PagedKVCache.check_invariants``
in ``runtime.kv_cache`` raise ``PoolInvariantError`` (tagged with a rule
ID) on refcount non-conservation (POOL001), cross-slot page aliasing /
table-ownership drift (POOL002), free-list corruption (POOL003) and quant
scales detached from their page (POOL005).

This module adds the two ways those invariants get exercised:

* **Static audit (POOL004)** — parses ``kv_cache.py`` and verifies every
  mutation of the protected bookkeeping happens inside a sanctioned
  method.  The port updates its pools in place, mostly through local
  names (``bs, pools, ... = self.block_size, self.pools, ...``, ``for
  key, leaf in c.items()``) and inside step closures, so the scan follows
  aliases of a protected attribute as well as ``self.<attr>`` itself, and
  counts in-place tensor writes (``x[...] = ...``, ``copy_``,
  ``index_copy_``, ``fill_``, ``zero_``, any ``*_`` method) beside
  container mutations.  A mutation from an unsanctioned method is exactly
  the kind of site the runtime checks can miss, so it must either be added
  to the sanctioned list — which also enrolls it in the sanitizer — or be
  refactored away.
* **Runtime sanitizer** — ``attach_sanitizer(kv)`` wraps every mutating
  ``PagedKVCache`` method so the full invariant suite runs after each
  call.  ``PagedKVCache.__init__`` attaches it when ``REPRO_SANITIZE`` is
  set.
"""

from __future__ import annotations

import ast
import functools
import inspect

from repro_torch.analysis import Finding

#: PagedKVCache methods the sanitizer wraps: everything that mutates pool
#: bookkeeping (pages, tables, ownership, registry, pool tensors).
SANITIZED_METHODS = (
    "alloc", "map_shared", "shield", "publish", "ensure_write", "truncate",
    "release", "register_prefix", "reclaim_for", "clear_prefixes",
    "clear_stranded_prefixes", "load_prefixes", "scatter",
)

#: POOL004 spec: per class, the bookkeeping attributes nothing outside the
#: sanctioned methods may mutate.  Sanctioned methods are exactly the
#: sites the runtime invariant checks (and the sanitizer) cover: the
#: port's ``_make_scatter`` builds the graph ``scatter`` runs, and
#: ``_copy_block`` is ``ensure_write``'s copy-on-write page copy.
PROTECTED = {
    "BlockAllocator": dict(
        attrs={"_free", "_ref"},
        methods={"__init__", "alloc", "incref", "free"},
    ),
    "PrefixRegistry": dict(
        attrs={"_entries", "_block_use"},
        methods={"__init__", "get", "put", "pop_lru", "clear",
                 "drop_stranded", "_retain", "_release"},
    ),
    "PagedKVCache": dict(
        attrs={"_owned", "page_table", "pools"},
        methods={"__init__", "alloc", "map_shared", "shield", "publish",
                 "ensure_write", "truncate", "release", "scatter",
                 "load_prefixes", "_copy_block", "_make_scatter"},
    ),
}

#: Method calls that mutate a container in place.
_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "setdefault", "move_to_end", "sort", "reverse", "fill",
    "__setitem__", "__delitem__",
}
#: Calls that return a view or an element of their receiver (so the
#: result aliases it).
_VIEWS = {"items", "values", "get", "view", "reshape", "narrow", "select",
          "view_as", "unsqueeze", "squeeze", "flatten", "transpose", "permute",
          "expand", "as_strided", "__getitem__"}


def _is_mutator(attr: str) -> bool:
    """A container mutator, or a tensor's in-place method (``copy_``,
    ``index_copy_``, ``zero_``: torch's trailing underscore)."""
    return attr in _MUTATORS or (attr.endswith("_") and not attr.startswith("_"))


class _MutationScan:
    """Collect (attr, lineno) mutations of protected state in one method,
    through ``self.<attr>`` and through local aliases of it."""

    def __init__(self, attrs: set[str]):
        self.attrs = attrs
        self.aliases: dict[str, str] = {}  # local name -> protected attr
        self.hits: list[tuple[str, int]] = []

    def root(self, node: ast.AST) -> str | None:
        """The protected attr ``node`` derives from (through subscripts,
        attributes and view calls), or None."""
        while True:
            if isinstance(node, ast.Subscript):
                node = node.value
            elif isinstance(node, ast.Attribute):
                if isinstance(node.value, ast.Name) and node.value.id == "self":
                    return node.attr if node.attr in self.attrs else None
                node = node.value
            elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                  and node.func.attr in _VIEWS):
                node = node.func.value
            elif isinstance(node, ast.Name):
                return self.aliases.get(node.id)
            else:
                return None

    def bind(self, target: ast.AST, value: ast.AST | None, iterating: bool = False) -> bool:
        """Record aliases bound by ``target = value`` (element-wise for
        tuples; every name of a ``for`` target over an aliased iterable).
        Returns True when one was added."""
        if isinstance(target, (ast.Tuple, ast.List)):
            if (not iterating and isinstance(value, (ast.Tuple, ast.List))
                    and len(value.elts) == len(target.elts)):
                return any([self.bind(t, v) for t, v in zip(target.elts, value.elts)])
            return any([self.bind(t, value, iterating) for t in target.elts])
        if isinstance(target, ast.Name) and value is not None:
            attr = self.root(value)
            if attr is not None and self.aliases.get(target.id) != attr:
                self.aliases[target.id] = attr
                return True
        return False

    def scan(self, fn: ast.AST) -> list[tuple[str, int]]:
        nodes = list(ast.walk(fn))
        changed = True
        while changed:  # aliases of aliases, in any order: to a fixpoint
            changed = False
            for node in nodes:
                if isinstance(node, ast.Assign):
                    changed |= any([self.bind(t, node.value) for t in node.targets])
                elif isinstance(node, (ast.For, ast.comprehension)):
                    changed |= self.bind(node.target, node.iter, iterating=True)
        for node in nodes:
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign, ast.Delete)):
                targets = (node.targets if isinstance(node, (ast.Assign, ast.Delete))
                           else [node.target])
                for t in targets:
                    for el in (t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]):
                        self.check_target(el, node.lineno)
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and _is_mutator(node.func.attr):
                attr = self.root(node.func.value)
                if attr is not None:
                    self.hits.append((attr, node.lineno))
        return self.hits

    def check_target(self, target: ast.AST, lineno: int) -> None:
        # Rebinding a local name is no mutation; a store through self.<attr>
        # or a subscript / attribute of an alias is.
        if isinstance(target, ast.Name):
            return
        attr = self.root(target)
        if attr is not None:
            self.hits.append((attr, lineno))


def audit_mutation_sites(module=None) -> list[Finding]:
    """POOL004: every mutation of protected pool bookkeeping must live in
    a sanctioned (invariant-covered) method."""
    if module is None:
        from repro_torch.runtime import kv_cache as module
    tree = ast.parse(inspect.getsource(module))
    findings: list[Finding] = []
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef) or cls.name not in PROTECTED:
            continue
        spec = PROTECTED[cls.name]
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            hits = _MutationScan(spec["attrs"]).scan(fn)
            if hits and fn.name not in spec["methods"]:
                attrs = sorted({a for a, _ in hits})
                lines = sorted({ln for _, ln in hits})
                findings.append(Finding(
                    "POOL004", f"{cls.name}.{fn.name}",
                    f"mutates protected {attrs} at line(s) {lines} but is not a "
                    "sanctioned mutation site — add it to poolcheck.PROTECTED (and the "
                    "sanitizer) or refactor the mutation into a sanctioned method", "pool"))
    return findings


def audit_pool(kv, path: str = "pool") -> list[Finding]:
    """Run the live invariant suite on one pool; violations come back as
    findings tagged with the rule the raising check carries."""
    from repro_torch.runtime.kv_cache import PoolInvariantError

    try:
        kv.check_invariants()
    except PoolInvariantError as e:
        return [Finding(e.rule, path, str(e), "pool")]
    return []


def attach_sanitizer(kv) -> None:
    """Wrap every mutating ``PagedKVCache`` method of ``kv`` so the full
    invariant suite runs after each call (``REPRO_SANITIZE=1``)."""
    for name in SANITIZED_METHODS:
        fn = getattr(kv, name, None)
        if fn is None:
            continue

        def make(wrapped):
            @functools.wraps(wrapped)
            def guard(*args, **kwargs):
                out = wrapped(*args, **kwargs)
                kv.check_invariants()
                return out
            return guard

        setattr(kv, name, make(fn))
    kv.sanitized = True


def audit_pools() -> list[Finding]:
    """Full pass 3: the static POOL004 audit plus a live-pool invariant
    run over a small exercised pool per kv dtype (on the CPU)."""
    import repro_torch.configs as C
    from repro_torch.runtime.kv_cache import PagedKVCache

    findings = audit_mutation_sites()
    cfg = C.get_smoke_config("qwen3-4b")
    for kv_dtype in ("fp32", "int8"):
        kv = PagedKVCache(cfg, max_batch=2, max_seq=64, block_size=16, num_blocks=9,
                          kv_dtype=kv_dtype, device="cpu")
        # Exercise the mutation surface, then audit: alloc/shield/publish,
        # a token append past the first page, truncate, and release.
        assert kv.alloc(0, 20)
        kv.shield(0)
        kv.publish(0)
        kv.ensure_write(0, 20)
        kv.truncate(0, 17)
        assert kv.alloc(1, 8)
        kv.publish(1)
        findings.extend(audit_pool(kv, f"PagedKVCache[{kv_dtype}]"))
        kv.release(0)
        kv.release(1)
        findings.extend(audit_pool(kv, f"PagedKVCache[{kv_dtype}]/drained"))
    return findings
