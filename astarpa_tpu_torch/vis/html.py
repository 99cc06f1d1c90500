"""Interactive HTML export (re-design of the `pa-web` crate).

The port's own copy of ``astarpa_tpu/vis/html.py`` (the code kept
identical, the page's title included, so both packages write the same
bytes).  The reference renders the visualizer to an HTML canvas via WASM
with prev/next stepping (`pa-web/src/lib.rs:14-48`, `html.rs`); here the
frames are PNGs embedded base64 into a single self-contained page with the
same prev/next (h/l keys) interaction.
"""

from __future__ import annotations

import base64
from pathlib import Path

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>astarpa_tpu visualizer</title>
<style>
 body {{ background:#111; color:#eee; font-family:monospace; text-align:center }}
 img {{ image-rendering: pixelated; border:1px solid #444; margin-top:1em }}
</style></head>
<body>
<h3>astarpa_tpu — {title}</h3>
<div><button onclick="step(-1)">&#8592; prev</button>
<span id="idx"></span>
<button onclick="step(1)">next &#8594;</button></div>
<img id="frame" />
<script>
const frames = [{frames}];
let i = frames.length - 1;
function show() {{
  document.getElementById('frame').src = 'data:image/png;base64,' + frames[i];
  document.getElementById('idx').textContent = ` ${{i + 1}} / ${{frames.length}} `;
}}
function step(d) {{ i = Math.min(frames.length - 1, Math.max(0, i + d)); show(); }}
document.addEventListener('keydown', e => {{
  if (e.key === 'h' || e.key === 'ArrowLeft') step(-1);
  if (e.key === 'l' || e.key === 'ArrowRight') step(1);
}});
show();
</script></body></html>
"""


def export_html(frame_dir, out_path, title: str = "alignment") -> None:
    """Bundle the PNG frames in ``frame_dir`` into one interactive page."""
    frames = sorted(Path(frame_dir).glob("*.png"))
    if not frames:
        raise FileNotFoundError(f"no frames in {frame_dir}")
    data = ",".join(
        f"'{base64.b64encode(f.read_bytes()).decode()}'" for f in frames
    )
    Path(out_path).write_text(_PAGE.format(title=title, frames=data))
