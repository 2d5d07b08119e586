"""Flight server sessions (after arrow_go_tpu/flight/session.py;
reference arrow/flight/session): cookie-based server state with the
Set/Get/CloseSessionOptions actions.

On a server:

    class MyServer(FlightServerBase):
        def __init__(self):
            super().__init__(...)
            self.sessions = SessionManager()
        def do_get(self, ctx, ticket):
            sess = self.sessions.session(ctx)   # creates one, sets a cookie

A client sends the cookies back with CookieMiddleware (reference
cookie_middleware.go), a middleware of the port's rpc layer where the
JAX one is a grpc interceptor.
"""
from __future__ import annotations

import threading
import uuid
from typing import Dict, Optional

from .rpc import ClientMiddleware

COOKIE_NAME = "arrow_flight_session_id"


class Session(dict):
    """One client's key/value state."""

    def __init__(self, session_id: str):
        super().__init__()
        self.id = session_id
        self.closed = False


class SessionManager:
    """Server-side cookie sessions (reference session/session.go's
    stateful middleware)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sessions: Dict[str, Session] = {}

    def _cookie_from(self, ctx) -> Optional[str]:
        for k, v in ctx.invocation_metadata() or ():
            if k.lower() == "cookie":
                for part in v.split(";"):
                    part = part.strip()
                    if part.startswith(COOKIE_NAME + "="):
                        return part.split("=", 1)[1]
        return None

    def session(self, ctx) -> Session:
        """The request cookie's session, or a new one (and a Set-Cookie
        header on the response)."""
        sid = self._cookie_from(ctx)
        with self._lock:
            if sid and sid in self._sessions:
                return self._sessions[sid]
            sid = uuid.uuid4().hex
            sess = Session(sid)
            self._sessions[sid] = sess
        try:
            ctx.send_initial_metadata(
                (("set-cookie", f"{COOKIE_NAME}={sid}"),))
        except RuntimeError:
            pass               # the call's headers went out already
        return sess

    def close(self, ctx) -> bool:
        sid = self._cookie_from(ctx)
        with self._lock:
            sess = self._sessions.pop(sid, None)
        if sess is not None:
            sess.closed = True
            return True
        return False

    def __len__(self) -> int:
        return len(self._sessions)


class CookieMiddleware(ClientMiddleware):
    """Keeps the server's cookies and sends them with every call."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cookies: Dict[str, str] = {}

    def sending_headers(self, method: str):
        with self._lock:
            if not self._cookies:
                return []
            return [("cookie", "; ".join(f"{k}={v}" for k, v in
                                         self._cookies.items()))]

    def received_headers(self, method: str, metadata) -> None:
        for k, v in metadata or ():
            if k.lower() == "set-cookie" and "=" in v:
                name, val = v.split("=", 1)
                with self._lock:
                    self._cookies[name.strip()] = val.split(";")[0].strip()
