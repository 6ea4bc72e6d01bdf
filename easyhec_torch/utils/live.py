"""Live run monitoring: a zero-dependency dashboard over the metrics stream.

Copy of easyhec_tpu/utils/live.py. The trainer streams ``metrics.jsonl``
and ``images/*.png`` into the run dir (utils/logging.MetricsWriter):

- ``write_dashboard(run_dir)`` drops a self-contained ``live.html`` beside
  them (inline JS/canvas, no external assets) that polls ``metrics.jsonl``
  every 2 s, plots every scalar series, and shows the newest image panel
  per tag.
- ``serve(run_dir, port)`` runs a threaded standard-library HTTP server
  rooted at the run dir on 127.0.0.1 (browsers block file:// fetches), with
  an ``/api/ls`` endpoint listing ``images/``.
- CLI: ``python -m easyhec_torch.cli.watch <run_dir>`` does both and blocks.
"""
from __future__ import annotations

import json
import threading
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

__all__ = ["write_dashboard", "serve", "DASHBOARD_NAME"]

DASHBOARD_NAME = "live.html"

_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>easyhec_torch live</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 1.2em; background: #111;
        color: #ddd; }
 h1 { font-size: 1.1em; } h2 { font-size: 0.95em; color: #9ad; }
 canvas { background: #181818; border: 1px solid #333; }
 .imgs img { max-width: 420px; margin: 4px; border: 1px solid #333; }
 .meta { color: #888; font-size: 0.85em; }
</style></head><body>
<h1>easyhec_torch live run monitor</h1>
<div class="meta" id="meta">waiting for metrics.jsonl ...</div>
<div id="charts"></div>
<h2>latest image panels</h2>
<div class="imgs" id="imgs"></div>
<script>
const charts = {};
function chartFor(key) {
  if (!charts[key]) {
    const wrap = document.createElement('div');
    const title = document.createElement('h2');
    title.textContent = key;
    const cv = document.createElement('canvas');
    cv.width = 860; cv.height = 180;
    wrap.appendChild(title); wrap.appendChild(cv);
    document.getElementById('charts').appendChild(wrap);
    charts[key] = cv;
  }
  return charts[key];
}
function plot(cv, xs, ys) {
  const ctx = cv.getContext('2d');
  ctx.clearRect(0, 0, cv.width, cv.height);
  if (!xs.length) return;
  const ymin = Math.min(...ys), ymax = Math.max(...ys);
  const xmin = xs[0], xmax = xs[xs.length - 1] || 1;
  const sx = x => 40 + (cv.width - 50) * (x - xmin) / Math.max(xmax - xmin, 1e-9);
  const sy = y => 10 + (cv.height - 30) * (1 - (y - ymin) / Math.max(ymax - ymin, 1e-9));
  ctx.strokeStyle = '#6cf'; ctx.beginPath();
  xs.forEach((x, i) => i ? ctx.lineTo(sx(x), sy(ys[i])) : ctx.moveTo(sx(x), sy(ys[i])));
  ctx.stroke();
  ctx.fillStyle = '#aaa'; ctx.font = '11px monospace';
  ctx.fillText(ymax.toPrecision(5), 4, 14);
  ctx.fillText(ymin.toPrecision(5), 4, cv.height - 16);
  ctx.fillText('step ' + xmax + '  last ' + ys[ys.length - 1].toPrecision(6),
               cv.width - 260, cv.height - 6);
}
async function tick() {
  try {
    const r = await fetch('metrics.jsonl', {cache: 'no-store'});
    if (r.ok) {
      const lines = (await r.text()).trim().split('\\n').filter(Boolean);
      const rows = lines.map(l => { try { return JSON.parse(l); } catch { return null; } })
                        .filter(Boolean);
      const keys = new Set();
      rows.forEach(row => Object.keys(row).forEach(k => {
        if (k !== 'step' && k !== 'time') keys.add(k); }));
      document.getElementById('meta').textContent =
        rows.length + ' records, ' + keys.size + ' series — ' + new Date().toLocaleTimeString();
      for (const k of keys) {
        const pts = rows.filter(r => typeof r[k] === 'number');
        plot(chartFor(k), pts.map(r => r.step), pts.map(r => r[k]));
      }
    }
    const ls = await fetch('api/ls', {cache: 'no-store'});
    if (ls.ok) {
      const files = await ls.json();
      const latest = {};
      for (const f of files) {
        const m = f.match(/^(.*)_(\\d+)\\.png$/);
        if (m && (!(m[1] in latest) || +m[2] > latest[m[1]][1]))
          latest[m[1]] = [f, +m[2]];
      }
      const div = document.getElementById('imgs');
      div.innerHTML = '';
      for (const tag of Object.keys(latest).sort()) {
        const img = document.createElement('img');
        img.src = 'images/' + latest[tag][0] + '?t=' + Date.now();
        img.title = tag + ' @ step ' + latest[tag][1];
        div.appendChild(img);
      }
    }
  } catch (e) { /* run not started yet */ }
  setTimeout(tick, 2000);
}
tick();
</script></body></html>
"""


def write_dashboard(run_dir: str | Path) -> Path:
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    path = run_dir / DASHBOARD_NAME
    path.write_text(_HTML)
    return path


class _Handler(SimpleHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 (stdlib API)
        if self.path.startswith("/api/ls"):
            img_dir = Path(self.directory) / "images"
            files = sorted(p.name for p in img_dir.glob("*.png")) if img_dir.is_dir() else []
            body = json.dumps(files).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        super().do_GET()

    def log_message(self, *args):  # quiet
        pass


def serve(
    run_dir: str | Path, port: int = 8008, background: bool = False
) -> ThreadingHTTPServer:
    """Serve the run dir (with /api/ls) on 127.0.0.1:port. background=True
    runs in a daemon thread and returns the server (call .shutdown() and
    .server_close())."""
    run_dir = str(Path(run_dir).resolve())

    def handler(*args, **kw):
        return _Handler(*args, directory=run_dir, **kw)

    srv = ThreadingHTTPServer(("127.0.0.1", port), handler)
    if background:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv
    try:
        srv.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover - interactive
        pass
    finally:
        srv.server_close()
    return srv
