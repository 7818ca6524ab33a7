"""Render HTML API pages from the live docstrings — zero dependencies.

The reference ships a Sphinx pipeline (``/root/reference/docs/conf.py``)
that autodocs its modules. This environment has no sphinx/mkdocs (and no
package installs), so this generator walks ``bask_tpu`` with ``inspect``
and writes one HTML page per module plus an index to ``docs/api/``:
module docstring, public functions (signature + docstring), public
classes (docstring, ``__init__`` signature, public methods/properties).
``docs/conf.py`` remains a working Sphinx configuration for
environments that have sphinx installed; ``make docs`` runs this
generator, which needs only the standard library.

Usage:  python docs/gen_api.py [outdir]
"""

from __future__ import annotations

import html
import importlib
import inspect
import pkgutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

_STYLE = """
body { font-family: -apple-system, 'Segoe UI', sans-serif; margin: 2rem
  auto; max-width: 60rem; padding: 0 1rem; color: #1a1a1a; }
h1 { border-bottom: 2px solid #ddd; padding-bottom: .3rem; }
h2 { margin-top: 2rem; color: #234; }
h3 { margin: 1.2rem 0 .2rem; color: #345; font-family: monospace; }
pre.doc { background: #f7f7f8; border-left: 3px solid #cbd; padding:
  .6rem .8rem; white-space: pre-wrap; font-size: .86rem; margin: .2rem
  0 .8rem; }
code.sig { background: #eef2f6; padding: .1rem .35rem; border-radius:
  4px; font-size: .9rem; }
a { color: #1558b0; text-decoration: none; }
nav { font-size: .9rem; margin-bottom: 1rem; }
.kind { color: #888; font-size: .75rem; text-transform: uppercase;
  letter-spacing: .05em; margin-right: .5rem; }
"""


def _page(title: str, body: str) -> str:
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title>"
        f"<style>{_STYLE}</style></head><body>"
        "<nav><a href='index.html'>bask-tpu API index</a></nav>"
        f"{body}</body></html>"
    )


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return f"<pre class='doc'>{html.escape(d)}</pre>" if d else ""


def _sig(obj) -> str:
    try:
        return html.escape(str(inspect.signature(obj)))
    except (ValueError, TypeError):
        return "(...)"


def _is_local(obj, modname: str) -> bool:
    return getattr(obj, "__module__", None) == modname


def _render_class(cls, modname: str) -> str:
    out = [
        f"<h3 id='{cls.__name__}'><span class='kind'>class</span>"
        f"{cls.__name__}<code class='sig'>{_sig(cls)}</code></h3>",
        _doc(cls),
    ]
    for name, member in sorted(vars(cls).items()):
        if name.startswith("_") and name != "__call__":
            continue
        if isinstance(member, property):
            out.append(
                f"<h3 id='{cls.__name__}.{name}'>"
                f"<span class='kind'>property</span>"
                f"{cls.__name__}.{name}</h3>" + _doc(member)
            )
        elif inspect.isfunction(member):
            out.append(
                f"<h3 id='{cls.__name__}.{name}'>"
                f"<span class='kind'>method</span>{cls.__name__}.{name}"
                f"<code class='sig'>{_sig(member)}</code></h3>"
                + _doc(member)
            )
    return "\n".join(out)


def _render_module(modname: str) -> str:
    mod = importlib.import_module(modname)
    parts = [f"<h1>{html.escape(modname)}</h1>", _doc(mod)]
    public = getattr(mod, "__all__", None)
    names = public or [n for n in sorted(vars(mod)) if not n.startswith("_")]
    funcs, classes = [], []
    for name in names:
        obj = getattr(mod, name, None)
        if obj is None:
            continue
        if inspect.isclass(obj) and (public or _is_local(obj, modname)):
            classes.append(obj)
        elif inspect.isfunction(obj) and (
            public or _is_local(obj, modname)
        ):
            funcs.append((name, obj))
    if classes:
        parts.append("<h2>Classes</h2>")
        parts.extend(_render_class(c, modname) for c in classes)
    if funcs:
        parts.append("<h2>Functions</h2>")
        for name, fn in funcs:
            parts.append(
                f"<h3 id='{name}'><span class='kind'>def</span>{name}"
                f"<code class='sig'>{_sig(fn)}</code></h3>" + _doc(fn)
            )
    return _page(modname, "\n".join(parts))


def main(outdir: str | None = None) -> Path:
    # CPU + x64 so importing compute modules never opens an accelerator
    import jax

    jax.config.update("jax_platforms", "cpu")

    out = Path(outdir) if outdir else REPO / "docs" / "api"
    out.mkdir(parents=True, exist_ok=True)

    import bask_tpu

    modnames = ["bask_tpu"]
    for info in pkgutil.walk_packages(
        bask_tpu.__path__, prefix="bask_tpu."
    ):
        modnames.append(info.name)

    written = []
    for modname in sorted(modnames):
        try:
            htmlsrc = _render_module(modname)
        except Exception as e:  # a broken page should name itself
            htmlsrc = _page(
                modname,
                f"<h1>{modname}</h1><pre class='doc'>render failed: "
                f"{html.escape(repr(e))}</pre>",
            )
        path = out / (modname + ".html")
        path.write_text(htmlsrc)
        written.append(modname)

    index_items = "\n".join(
        f"<li><a href='{m}.html'><code>{m}</code></a></li>"
        for m in sorted(written)
    )
    (out / "index.html").write_text(
        _page(
            "bask-tpu API",
            "<h1>bask-tpu API reference</h1>"
            "<p>Generated from the live docstrings by docs/gen_api.py "
            "(<code>make docs</code>).</p>"
            f"<ul>{index_items}</ul>",
        )
    )
    print(f"wrote {len(written) + 1} pages to {out}")
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
