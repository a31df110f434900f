"""The module tree of a model as a graphviz graph and a parameter table.

Port of det3d_tpu/visualization/netviz.py (reference det3d/visualization/
netviz.py). The JAX package walks a flax params tree; here the walk is the
torch module tree (``named_children``), with each module's parameter count
(``parameters()``: parameters only, not buffers such as BatchNorm's running
statistics, as the JAX package counts ``params`` and not
``batch_stats``). A module without parameters is left out, as flax's tree
holds no entry for it. ``render`` writes dot source, and an image where
the python ``graphviz`` package and its binary are installed.
"""

from __future__ import annotations

from torch import nn


def _count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def _has_params(module: nn.Module) -> bool:
    return any(True for _ in module.parameters())


def module_graph(model: nn.Module, name: str = "model"):
    """model -> (nodes, edges): nodes (path, label) with parameter counts
    (a module with child modules) or parameter shapes (a module with only
    its own parameters, or a parameter held beside child modules); edges
    parent -> child."""
    nodes = [("", f"{name}\\n{_count(model):,} params")]
    edges = []

    def walk(prefix, module):
        for k, p in module.named_parameters(recurse=False):
            path = f"{prefix}/{k}" if prefix else k
            nodes.append((path, f"{k}\\n{tuple(p.shape)}"))
            edges.append((prefix, path))
        for k, m in module.named_children():
            if not _has_params(m):
                continue
            path = f"{prefix}/{k}" if prefix else k
            edges.append((prefix, path))
            if any(_has_params(c) for c in m.children()):
                nodes.append((path, f"{k}\\n{_count(m):,}"))
                walk(path, m)
            else:
                shapes = ", ".join(f"{n}{tuple(p.shape)}" for n, p in
                                   m.named_parameters(recurse=False))
                nodes.append((path, f"{k}\\n{shapes}"))

    walk("", model)
    return nodes, edges


def to_dot(model: nn.Module, name: str = "model") -> str:
    """Graphviz dot source of the module tree."""
    nodes, edges = module_graph(model, name)
    out = [f'digraph "{name}" {{',
           '  rankdir=TB; node [shape=box, fontsize=10, '
           'style="rounded,filled", fillcolor="#eef3fb"];']
    for path, label in nodes:
        out.append(f'  "{path or name}" [label="{label}"];')
    for a, b in edges:
        out.append(f'  "{a or name}" -> "{b}";')
    out.append("}")
    return "\n".join(out)


def render(model: nn.Module, path: str, name: str = "model",
           fmt: str = "png"):
    """Write dot source to <path>.dot and, where the graphviz package and
    binary are installed, the graph to <path>.<fmt>. Returns the paths
    written."""
    from pathlib import Path
    src = to_dot(model, name)
    dot_path = Path(str(path) + ".dot")
    dot_path.write_text(src)
    written = [str(dot_path)]
    try:                                               # pragma: no cover
        import graphviz
        written.append(graphviz.Source(src).render(
            filename=str(path), format=fmt, cleanup=True))
    except Exception:
        pass
    return written


def summarize(model: nn.Module) -> str:
    """Text table of the top-level modules (and parameters) with their
    parameter counts and shares, largest first, and the total."""
    rows = [(k, p.numel()) for k, p in model.named_parameters(recurse=False)]
    rows += [(k, _count(m)) for k, m in model.named_children()
             if _has_params(m)]
    total = sum(c for _, c in rows) or 1
    width = max((len(k) for k, _ in rows), default=4)
    lines = [f"{'module':<{width}}  {'params':>12}  share"]
    for k, c in sorted(rows, key=lambda r: -r[1]):
        lines.append(f"{k:<{width}}  {c:>12,}  {100.0 * c / total:5.1f}%")
    lines.append(f"{'total':<{width}}  {total:>12,}")
    return "\n".join(lines)
