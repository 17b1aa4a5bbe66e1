"""Tiny routing HTTP server on http.server with WebSocket upgrade support
(univer_ocr_tpu/web/httpd.py).

Route handlers return (status, content_type, body) or an HTML string;
`@app.route('/image/<mode>/<type>')`-style path params are supported.
WebSocket routes receive a WebSocketConnection after the handshake.
`start_background(port=0)` binds an ephemeral port, which `app.port`
then reports; `shutdown()` stops the server and runs the callbacks
registered with `on_close` (the OCR pipelines' thread pools).
"""

import re
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

from .websocket import Hub, WebSocketConnection, accept_key

TEMPLATES_DIR = Path(__file__).parent / 'templates'
STATIC_DIR = Path(__file__).parent / 'static'

MIME = {
    '.html': 'text/html; charset=utf-8',
    '.css': 'text/css',
    '.js': 'application/javascript',
    '.png': 'image/png',
    '.ico': 'image/x-icon',
}


def render_template(name, **context):
    """Very small templating: `{{> partial.html }}` includes and
    `{{ name }}` substitutions over templates/<name>."""
    text = (TEMPLATES_DIR / name).read_text()
    for partial in re.findall(r'\{\{>\s*([\w.]+)\s*\}\}', text):
        text = text.replace('{{> %s }}' % partial,
                            (TEMPLATES_DIR / partial).read_text())
    for key, value in context.items():
        text = text.replace('{{ %s }}' % key, str(value))
    return text


class App:
    def __init__(self):
        self._routes = []          # (regex, param_names, handler, methods)
        self._ws_routes = {}       # path -> handler(conn, app)
        self._on_close = []
        self.hub = Hub()
        self.state = {}
        self.server = None
        self.port = None

    def route(self, pattern, methods=('GET',)):
        param_names = re.findall(r'<(\w+)>', pattern)
        regex = re.compile(
            '^' + re.sub(r'<\w+>', r'([^/]+)', pattern) + '$')

        def decorator(func):
            self._routes.append((regex, param_names, func, tuple(methods)))
            return func
        return decorator

    def ws_route(self, path):
        def decorator(func):
            self._ws_routes[path] = func
            return func
        return decorator

    def on_close(self, func):
        """Run `func()` when the server shuts down."""
        self._on_close.append(func)
        return func

    def dispatch(self, path, query, method='GET', body=None):
        for regex, names, func, methods in self._routes:
            m = regex.match(path)
            if m and method in methods:
                kwargs = dict(zip(names, m.groups()))
                if method != 'GET':
                    kwargs['body'] = body
                return func(query=query, **kwargs)
        return None

    def make_handler(self):
        app = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = 'HTTP/1.1'

            def log_message(self, fmt, *args):   # quiet
                pass

            def _send(self, status, ctype, body, extra_headers=()):
                if isinstance(body, str):
                    body = body.encode('utf-8')
                self.send_response(status)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(body)))
                for k, v in extra_headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parsed = urlparse(self.path)
                path = parsed.path
                query = {k: v[0] for k, v in parse_qs(parsed.query).items()}

                # WebSocket upgrade?
                if (path in app._ws_routes
                        and 'websocket' in
                        self.headers.get('Upgrade', '').lower()):
                    self._handle_ws(path)
                    return

                if path.startswith('/static/'):
                    self._serve_static(path[len('/static/'):])
                    return

                self._finish(path, query, 'GET', None)

            def do_POST(self):
                parsed = urlparse(self.path)
                query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                length = int(self.headers.get('Content-Length', 0))
                body = self.rfile.read(length) if length else b''
                self._finish(parsed.path, query, 'POST', body)

            def _finish(self, path, query, method, body):
                try:
                    result = app.dispatch(path, query, method, body)
                except Exception:
                    self._send(500, 'text/plain', traceback.format_exc())
                    return
                if result is None:
                    self._send(404, 'text/plain', 'Not Found')
                    return
                if isinstance(result, tuple):
                    status, ctype, rbody = result
                else:
                    status, ctype, rbody = 200, MIME['.html'], result
                self._send(status, ctype, rbody)

            def _serve_static(self, rel):
                target = (STATIC_DIR / rel).resolve()
                if (not str(target).startswith(str(STATIC_DIR.resolve()))
                        or not target.is_file()):
                    self._send(404, 'text/plain', 'Not Found')
                    return
                ctype = MIME.get(target.suffix, 'application/octet-stream')
                self._send(200, ctype, target.read_bytes())

            def _handle_ws(self, path):
                key = self.headers.get('Sec-WebSocket-Key', '')
                self.send_response(101, 'Switching Protocols')
                self.send_header('Upgrade', 'websocket')
                self.send_header('Connection', 'Upgrade')
                self.send_header('Sec-WebSocket-Accept', accept_key(key))
                self.end_headers()
                conn = WebSocketConnection(self)
                app.hub.join(path, conn)
                try:
                    app._ws_routes[path](conn, app)
                finally:
                    app.hub.leave(path, conn)
                    conn.close()
                self.close_connection = True

        return Handler

    def _bind(self, host, port):
        server = ThreadingHTTPServer((host, port), self.make_handler())
        server.daemon_threads = True
        self.server = server
        self.port = server.server_address[1]
        return server

    def run(self, host='127.0.0.1', port=8000):
        server = self._bind(host, port)
        print(f'Serving on http://{host}:{self.port}')
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
            self._close()

    def start_background(self, host='127.0.0.1', port=8000):
        """Serve from a daemon thread; port 0 binds a free port (read it
        from `app.port`).  Returns the server."""
        server = self._bind(host, port)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server

    def shutdown(self):
        """Stop a server started by start_background and run the on_close
        callbacks."""
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
        self._close()

    def _close(self):
        while self._on_close:
            self._on_close.pop()()
