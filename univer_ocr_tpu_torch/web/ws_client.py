"""Minimal WebSocket *client* for the trainer (univer_ocr_tpu/web/
ws_client.py).

The trainer connects back to the web server's /train-ws namespace and
emits message/info/progress_tracker events in the plain-WebSocket JSON
protocol of the server (websocket.py); tests and the smoke run use it as
the browser too, with `FrameReader` collecting what the server sends.
"""

import base64
import json
import os
import socket
import struct
import threading
import time


class WSClient:
    def __init__(self, host, port, path):
        self.sock = socket.create_connection((host, port), timeout=5)
        key = base64.b64encode(os.urandom(16)).decode()
        request = (
            f'GET {path} HTTP/1.1\r\n'
            f'Host: {host}:{port}\r\n'
            f'Upgrade: websocket\r\n'
            f'Connection: Upgrade\r\n'
            f'Sec-WebSocket-Key: {key}\r\n'
            f'Sec-WebSocket-Version: 13\r\n\r\n')
        self.sock.sendall(request.encode())
        response = b''
        while b'\r\n\r\n' not in response:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError('handshake failed')
            response += chunk
        if b'101' not in response.split(b'\r\n', 1)[0]:
            raise ConnectionError(f'unexpected handshake: {response[:200]!r}')

    def emit(self, event, data=None):
        payload = json.dumps({'event': event, 'data': data},
                             default=str).encode('utf-8')
        mask = os.urandom(4)
        header = bytes([0x81])
        n = len(payload)
        if n < 126:
            header += bytes([0x80 | n])
        elif n < (1 << 16):
            header += bytes([0x80 | 126]) + struct.pack('>H', n)
        else:
            header += bytes([0x80 | 127]) + struct.pack('>Q', n)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        try:
            self.sock.sendall(header + mask + masked)
        except OSError:
            pass

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class FrameReader:
    """A browser's side of a namespace: parses the server's (unmasked)
    frames on `sock` into `events`, `{"event": ..., "data": ...}` dicts,
    from a thread of its own until the socket closes."""

    def __init__(self, sock):
        self.events = []
        self.sock = sock
        self._buf = b''
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        self.sock.settimeout(1.0)
        while True:
            try:
                chunk = self.sock.recv(65536)
            except TimeoutError:
                continue
            except OSError:
                return
            if not chunk:
                return
            self._buf += chunk
            self._drain()

    def _drain(self):
        while len(self._buf) >= 2:
            n, off = self._buf[1] & 0x7F, 2
            if n == 126:
                if len(self._buf) < 4:
                    return
                n, off = struct.unpack('>H', self._buf[2:4])[0], 4
            elif n == 127:
                if len(self._buf) < 10:
                    return
                n, off = struct.unpack('>Q', self._buf[2:10])[0], 10
            if len(self._buf) < off + n:
                return
            payload, self._buf = (self._buf[off:off + n],
                                  self._buf[off + n:])
            try:
                self.events.append(json.loads(payload))
            except ValueError:
                pass

    def wait(self, pred, timeout):
        """Poll until `pred(events)` holds or `timeout` seconds pass;
        returns whether it held."""
        deadline = time.time() + timeout
        while not pred(list(self.events)):
            if time.time() >= deadline:
                return False
            time.sleep(0.1)
        return True


def connect_train_ws(host='127.0.0.1', port=8000, path='/train-ws'):
    return WSClient(host, port, path)
