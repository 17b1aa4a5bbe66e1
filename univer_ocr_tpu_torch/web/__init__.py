"""Web app: online OCR and the live training dashboard (univer_ocr_tpu/
web/).

The server is built on the stdlib: `httpd.py` (routing and templates over
http.server) and `websocket.py` (RFC 6455 frames over the same listener).
The browser-side protocol is plain WebSocket JSON `{"event": ..., "data":
...}` carrying the dashboard's event vocabulary (`message` / `info` /
`progress_tracker` / `start` / `stop`) on `/train-ws`.

    python -m univer_ocr_tpu_torch.web [port] [--cpu]
"""

from .app import create_app
