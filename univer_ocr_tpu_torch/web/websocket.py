"""Minimal RFC 6455 WebSocket server support over http.server sockets
(univer_ocr_tpu/web/websocket.py).

Implements just what the dashboard needs: the upgrade handshake, text
frames (client->server frames are masked per spec), close frames, and a
broadcast hub keyed by namespace path.
"""

import base64
import hashlib
import json
import struct
import threading

GUID = '258EAFA5-E914-47DA-95CA-C5AB0DC85B11'


def accept_key(sec_websocket_key):
    digest = hashlib.sha1((sec_websocket_key + GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def encode_frame(payload, opcode=0x1):
    """Server->client frame (unmasked)."""
    if isinstance(payload, str):
        payload = payload.encode('utf-8')
    header = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        header += bytes([n])
    elif n < (1 << 16):
        header += bytes([126]) + struct.pack('>H', n)
    else:
        header += bytes([127]) + struct.pack('>Q', n)
    return header + payload


def read_frame(rfile):
    """Read one client->server frame; returns (opcode, payload) or None on
    EOF/close."""
    head = rfile.read(2)
    if len(head) < 2:
        return None
    b1, b2 = head
    opcode = b1 & 0x0F
    masked = b2 & 0x80
    length = b2 & 0x7F
    if length == 126:
        length = struct.unpack('>H', rfile.read(2))[0]
    elif length == 127:
        length = struct.unpack('>Q', rfile.read(8))[0]
    mask = rfile.read(4) if masked else None
    payload = rfile.read(length)
    if masked:
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    if opcode == 0x8:      # close
        return None
    return opcode, payload


class WebSocketConnection:
    """One upgraded connection; thread-safe sends."""

    def __init__(self, handler):
        self.handler = handler
        self.wfile = handler.wfile
        self.rfile = handler.rfile
        self._send_lock = threading.Lock()
        self.open = True

    def send_event(self, event, data=None):
        self.send_text(json.dumps({'event': event, 'data': data}))

    def send_text(self, text):
        if not self.open:
            return
        try:
            with self._send_lock:
                self.wfile.write(encode_frame(text))
                self.wfile.flush()
        except OSError:
            self.open = False

    def recv_event(self):
        """Blocking read of the next JSON event; None when closed."""
        while True:
            frame = read_frame(self.rfile)
            if frame is None:
                self.open = False
                return None
            opcode, payload = frame
            if opcode == 0x9:   # ping -> pong
                with self._send_lock:
                    self.wfile.write(encode_frame(payload, opcode=0xA))
                    self.wfile.flush()
                continue
            if opcode != 0x1:
                continue
            try:
                msg = json.loads(payload.decode('utf-8'))
            except (ValueError, UnicodeDecodeError):
                continue
            return msg

    def close(self):
        if self.open:
            try:
                with self._send_lock:
                    self.wfile.write(encode_frame(b'', opcode=0x8))
                    self.wfile.flush()
            except OSError:
                pass
            self.open = False


class Hub:
    """Broadcast groups keyed by namespace path (e.g. '/train-ws')."""

    def __init__(self):
        self._groups = {}
        self._lock = threading.Lock()

    def join(self, namespace, conn):
        with self._lock:
            self._groups.setdefault(namespace, set()).add(conn)

    def leave(self, namespace, conn):
        with self._lock:
            self._groups.get(namespace, set()).discard(conn)

    def broadcast(self, namespace, event, data=None, exclude=None):
        with self._lock:
            conns = list(self._groups.get(namespace, ()))
        for conn in conns:
            if conn is exclude:
                continue
            conn.send_event(event, data)
            if not conn.open:
                self.leave(namespace, conn)
