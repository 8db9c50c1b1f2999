"""Minimal stand-in for the `gradio` API surface that `cli/app.py` uses
(copy of `stableavatar_tpu/utils/gradio_shim.py`; the reference UI is
`app.py:280-496`).

When the real gradio package is absent, this module implements the subset
of the Blocks API the app uses -- component construction, Tab / Row layout
grouping, Button.click event wiring -- plus a real (threaded, stdlib-only)
HTTP server in `Blocks.launch()`:

  GET  /                 rendered HTML listing of tabs + components
  POST /api/<event>      dispatch a click callback with JSON inputs
  GET  /mcp/tools        tool listing when launched with mcp_server=True
                         (the reference's MCP flag, `app.py:489-496`)

When real gradio IS importable it is used untouched; `ensure_gradio()`
installs this module under `sys.modules["gradio"]` only as a fallback.
The shim's event dispatch is what tests/test_torch_app.py drives end to end
(UI build -> click -> video on disk).
"""

from __future__ import annotations

import json
import sys
import threading
from typing import Any, Callable, List, Optional

__version__ = "0.0-stableavatar-shim"

_ctx_stack: List[Any] = []  # innermost-last stack of Blocks/Tab/Row


def _register(component):
    for ctx in reversed(_ctx_stack):
        if isinstance(ctx, Blocks):
            ctx.components.append(component)
            break
    for ctx in reversed(_ctx_stack):
        if isinstance(ctx, Tab):
            ctx.components.append(component)
            break


class Component:
    """Base: holds label/value; registers itself with the enclosing Blocks."""

    def __init__(self, value=None, *, label: Optional[str] = None,
                 type: Optional[str] = None, info: Optional[str] = None,
                 **_kw):
        self.value = value
        self.label = label
        self.type = type
        self.info = info
        _register(self)

    def __repr__(self):
        return f"{type(self).__name__}(label={self.label!r})"


class Image(Component):
    pass


class Audio(Component):
    pass


class Video(Component):
    pass


class Textbox(Component):
    pass


class Number(Component):
    pass


class Slider(Component):
    def __init__(self, minimum=0, maximum=1, value=None, *, step=None,
                 label=None, info=None, **kw):
        self.minimum, self.maximum, self.step = minimum, maximum, step
        super().__init__(value if value is not None else minimum,
                         label=label, info=info, **kw)


class Dropdown(Component):
    def __init__(self, choices=None, *, value=None, label=None, info=None,
                 **kw):
        self.choices = list(choices or [])
        super().__init__(value, label=label, info=info, **kw)


class Button(Component):
    def __init__(self, value="Button", **kw):
        super().__init__(value, **kw)

    def click(self, fn: Callable, inputs=None, outputs=None):
        for ctx in reversed(_ctx_stack):
            if isinstance(ctx, Blocks):
                ctx.events.append(
                    {
                        "name": str(self.value),
                        "fn": fn,
                        "inputs": list(inputs or []),
                        "outputs": list(outputs or []),
                    }
                )
                return self
        raise RuntimeError("Button.click outside a Blocks context")


class _Layout:
    def __enter__(self):
        _ctx_stack.append(self)
        return self

    def __exit__(self, *exc):
        assert _ctx_stack.pop() is self
        return False


class Row(_Layout):
    def __init__(self, **_kw):
        pass


class Tab(_Layout):
    def __init__(self, label: str = "", **_kw):
        self.label = label
        self.components: List[Component] = []
        _register_tab(self)


def _register_tab(tab: Tab):
    for ctx in reversed(_ctx_stack):
        if isinstance(ctx, Blocks):
            ctx.tabs.append(tab)
            break


class Blocks(_Layout):
    """Component graph + event registry + stdlib HTTP `launch()`."""

    def __init__(self, title: str = "", **_kw):
        self.title = title
        self.components: List[Component] = []
        self.tabs: List[Tab] = []
        self.events: List[dict] = []
        self.server = None
        self.server_port: Optional[int] = None
        self.mcp_server = False

    # --- programmatic dispatch (used directly by tests and /api) ---

    def dispatch(self, event_name: str, values: List[Any]):
        """Run the click handler registered under a button label; assigns
        returned values onto the output components and returns them."""
        for ev in self.events:
            if ev["name"] == event_name:
                break
        else:
            raise KeyError(
                f"no event {event_name!r}; have {[e['name'] for e in self.events]}"
            )
        if len(values) != len(ev["inputs"]):
            raise ValueError(
                f"{event_name}: expected {len(ev['inputs'])} inputs, got {len(values)}"
            )
        result = ev["fn"](*values)
        outs = ev["outputs"]
        if len(outs) == 1:
            result = (result,)
        for comp, val in zip(outs, result):
            comp.value = val
        return result

    def default_inputs(self, event_name: str) -> List[Any]:
        for ev in self.events:
            if ev["name"] == event_name:
                return [c.value for c in ev["inputs"]]
        raise KeyError(event_name)

    # --- HTML rendering -------------------------------------------------

    def _html(self) -> str:
        parts = [f"<html><head><title>{self.title}</title></head><body>",
                 f"<h1>{self.title}</h1>"]
        for tab in self.tabs:
            parts.append(f"<h2>{tab.label}</h2><ul>")
            for c in tab.components:
                parts.append(
                    f"<li>{type(c).__name__}: {c.label or c.value}</li>"
                )
            parts.append("</ul>")
        parts.append("<h2>events</h2><ul>")
        for ev in self.events:
            parts.append(
                f"<li>POST /api/{ev['name']} ({len(ev['inputs'])} inputs)</li>"
            )
        parts.append("</ul></body></html>")
        return "".join(parts)

    # --- server ---------------------------------------------------------

    def launch(self, server_name: str = "127.0.0.1", server_port: int = 7860,
               mcp_server: bool = False, prevent_thread_lock: bool = False,
               **_kw):
        import http.server

        blocks = self
        self.mcp_server = mcp_server

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/":
                    self._send(200, blocks._html().encode(), "text/html")
                elif self.path == "/mcp/tools" and blocks.mcp_server:
                    tools = [
                        {
                            "name": ev["name"],
                            "inputs": [c.label for c in ev["inputs"]],
                            "outputs": [c.label for c in ev["outputs"]],
                        }
                        for ev in blocks.events
                    ]
                    self._send(200, json.dumps({"tools": tools}).encode(),
                               "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                from urllib.parse import unquote

                path = unquote(self.path)
                if not path.startswith("/api/"):
                    self._send(404, b"not found", "text/plain")
                    return
                name = path[len("/api/"):]
                n = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    values = payload.get("data")
                    if values is None:
                        values = blocks.default_inputs(name)
                    result = blocks.dispatch(name, values)

                    def enc(r):
                        # JSON-native values pass through verbatim (paths,
                        # seeds, ...); non-serializable objects, circular
                        # structures, and NaN/Inf floats (invalid in strict
                        # JSON) fall back to repr
                        try:
                            json.dumps(r, allow_nan=False)
                            return r
                        except (TypeError, ValueError):
                            return repr(r)

                    body = json.dumps({"data": [enc(r) for r in result]},
                                      allow_nan=False)
                    self._send(200, body.encode(), "application/json")
                except Exception as e:  # surfaced to the client, not raised
                    self._send(500, json.dumps({"error": str(e)}).encode(),
                               "application/json")

        self.server = http.server.ThreadingHTTPServer(
            (server_name, server_port), Handler
        )
        self.server_port = self.server.server_address[1]
        thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        thread.start()
        if not prevent_thread_lock:
            try:
                thread.join()
            except KeyboardInterrupt:
                pass
            finally:
                self.close()
        return self

    def close(self):
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.server = None


def ensure_gradio():
    """Return real gradio when importable, else this shim (installed under
    `sys.modules["gradio"]` when that name is free).  A `gradio` module
    that is itself a shim -- the JAX package's, in a process that imports
    both packages -- does not count as real gradio."""
    try:
        import gradio
    except ImportError:
        gradio = None
    if gradio is not None and not str(getattr(gradio, "__version__", "")).endswith("-shim"):
        return gradio
    mod = sys.modules[__name__]
    sys.modules.setdefault("gradio", mod)
    return mod
