"""OIDC login (PKCE S256) + session identity.

Behavior parity with the reference auth blueprint
(reference ``app/blueprints/auth.py``):

- ``/login``: generate state + nonce + PKCE verifier (stored in the
  session), redirect to the issuer's authorization endpoint with an S256
  challenge (reference ``auth.py:143-156``);
- ``/oidc/callback``: state/expiry check, code+verifier token exchange,
  id_token RS256 verification (aud/iss/exp/nonce) against the issuer JWKS
  — discovery document and JWKS cached 12 h (reference ``auth.py:49-101``),
  session rotation, user upsert (reference ``auth.py:158-199``);
- ``/logout``: clear session (reference ``auth.py:201-210``).

JWT verification is implemented directly on ``cryptography`` (no jose
dependency). When no issuer is configured the app falls back to a local
dev-login form so the framework runs standalone.
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import secrets
import time

from outline_rag_tpu_torch.serve.http import App, Request, Response

log = logging.getLogger(__name__)

DISCOVERY_CACHE_KEY = "oidc:discovery"
JWKS_CACHE_KEY = "oidc:jwks"
CACHE_TTL = 12 * 3600
STATE_TTL = 600


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _b64url_encode(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).decode().rstrip("=")


def verify_rs256_jwt(
    token: str,
    jwks: dict,
    audience: str,
    issuer: str,
    nonce: str | None = None,
) -> dict:
    """Verify signature + claims; returns the payload or raises ValueError."""
    from cryptography.hazmat.primitives.asymmetric import padding, rsa
    from cryptography.hazmat.primitives import hashes

    try:
        head_b64, payload_b64, sig_b64 = token.split(".")
    except ValueError as e:
        raise ValueError("malformed token") from e
    header = json.loads(_b64url_decode(head_b64))
    if header.get("alg") != "RS256":
        raise ValueError(f"unsupported alg {header.get('alg')}")
    kid = header.get("kid")
    key = None
    for k in jwks.get("keys", []):
        if kid is None or k.get("kid") == kid:
            key = k
            break
    if key is None or key.get("kty") != "RSA":
        raise ValueError("no matching RSA key in JWKS")
    n = int.from_bytes(_b64url_decode(key["n"]), "big")
    e = int.from_bytes(_b64url_decode(key["e"]), "big")
    pub = rsa.RSAPublicNumbers(e, n).public_key()
    signing_input = f"{head_b64}.{payload_b64}".encode()
    try:
        pub.verify(
            _b64url_decode(sig_b64), signing_input,
            padding.PKCS1v15(), hashes.SHA256(),
        )
    except Exception as exc:
        raise ValueError("bad signature") from exc
    payload = json.loads(_b64url_decode(payload_b64))
    if payload.get("exp", 0) < time.time():
        raise ValueError("token expired")
    aud = payload.get("aud")
    auds = aud if isinstance(aud, list) else [aud]
    if audience not in auds:
        raise ValueError("audience mismatch")
    if payload.get("iss") != issuer:
        raise ValueError("issuer mismatch")
    if nonce is not None and payload.get("nonce") != nonce:
        raise ValueError("nonce mismatch")
    return payload


class OIDC:
    def __init__(self, settings, bus, transport: httpx.AsyncBaseTransport | None = None):
        self.s = settings
        self.bus = bus
        self._transport = transport
        self._http = None

    @property
    def _client(self):
        # built at first use, not with the routes: the app (and its dev
        # login) serves on a machine without httpx
        if self._http is None:
            import httpx

            self._http = httpx.AsyncClient(transport=self._transport, timeout=15.0)
        return self._http

    @property
    def enabled(self) -> bool:
        return bool(self.s.oidc_issuer and self.s.oidc_client_id)

    async def discovery(self) -> dict:
        cached = await self.bus.get(DISCOVERY_CACHE_KEY)
        if cached:
            return cached
        url = self.s.oidc_issuer.rstrip("/") + "/.well-known/openid-configuration"
        resp = await self._client.get(url)
        resp.raise_for_status()
        doc = resp.json()
        await self.bus.set(DISCOVERY_CACHE_KEY, doc, ex=CACHE_TTL)
        return doc

    async def jwks(self, force: bool = False) -> dict:
        cached = None if force else await self.bus.get(JWKS_CACHE_KEY)
        if cached:
            return cached
        doc = await self.discovery()
        resp = await self._client.get(doc["jwks_uri"])
        resp.raise_for_status()
        keys = resp.json()
        await self.bus.set(JWKS_CACHE_KEY, keys, ex=CACHE_TTL)
        return keys

    async def exchange_code(self, code: str, verifier: str) -> dict:
        doc = await self.discovery()
        resp = await self._client.post(
            doc["token_endpoint"],
            data={
                "grant_type": "authorization_code",
                "code": code,
                "redirect_uri": self.s.oidc_redirect_url,
                "client_id": self.s.oidc_client_id,
                "client_secret": self.s.oidc_client_secret,
                "code_verifier": verifier,
            },
        )
        resp.raise_for_status()
        return resp.json()


def register_auth_routes(app: App, settings, bus, meta, prefix: str = "/chat",
                         oidc_transport=None) -> None:
    oidc = OIDC(settings, bus, transport=oidc_transport)
    app.state["oidc"] = oidc

    @app.get(prefix + "/login")
    async def login(req: Request) -> Response:
        if not oidc.enabled:
            # dev fallback: serve a minimal local login form
            return Response(
                "<html><body><form method='post'>"
                "<input name='name' placeholder='name'/>"
                "<button>Sign in (dev)</button></form></body></html>",
                content_type="text/html; charset=utf-8",
            )
        doc = await oidc.discovery()
        state = secrets.token_urlsafe(24)
        nonce = secrets.token_urlsafe(24)
        verifier = _b64url_encode(secrets.token_bytes(48))
        challenge = _b64url_encode(
            hashlib.sha256(verifier.encode()).digest()
        )
        req.session = {
            "oidc_state": state,
            "oidc_nonce": nonce,
            "oidc_verifier": verifier,
            "oidc_ts": time.time(),
        }
        import urllib.parse

        params = urllib.parse.urlencode(
            {
                "response_type": "code",
                "client_id": settings.oidc_client_id,
                "redirect_uri": settings.oidc_redirect_url,
                "scope": "openid profile email",
                "state": state,
                "nonce": nonce,
                "code_challenge": challenge,
                "code_challenge_method": "S256",
            }
        )
        return Response.redirect(f"{doc['authorization_endpoint']}?{params}")

    @app.post(prefix + "/login")
    async def dev_login(req: Request) -> Response:
        if oidc.enabled:
            return Response.json({"error": "use OIDC login"}, 400)
        form = req.form()
        name = (form.get("name") or "").strip() or "dev"
        user_id = f"dev:{name}"
        meta.upsert_user(user_id, name, "")
        req.session = {"user": {"id": user_id, "name": name, "email": ""}}
        return Response.redirect(prefix + "/")

    @app.get(prefix + "/oidc/callback")
    async def callback(req: Request) -> Response:
        if not oidc.enabled:
            return Response.json({"error": "oidc not configured"}, 400)
        state = req.query.get("state", "")
        code = req.query.get("code", "")
        sess = req.session
        if (
            not state
            or state != sess.get("oidc_state")
            or time.time() - sess.get("oidc_ts", 0) > STATE_TTL
        ):
            return Response.json({"error": "invalid state"}, 400)
        try:
            tokens = await oidc.exchange_code(code, sess.get("oidc_verifier", ""))
            try:
                payload = verify_rs256_jwt(
                    tokens["id_token"],
                    await oidc.jwks(),
                    audience=settings.oidc_client_id,
                    issuer=settings.oidc_issuer,
                    nonce=sess.get("oidc_nonce"),
                )
            except ValueError as e:
                if "no matching RSA key" not in str(e):
                    raise
                # IdP signing-key rotation: the cached JWKS is stale for
                # up to its TTL — refetch once before failing the login
                payload = verify_rs256_jwt(
                    tokens["id_token"],
                    await oidc.jwks(force=True),
                    audience=settings.oidc_client_id,
                    issuer=settings.oidc_issuer,
                    nonce=sess.get("oidc_nonce"),
                )
        except Exception:
            log.exception("oidc callback failed")
            return Response.json({"error": "login failed"}, 401)
        user = {
            "id": str(payload.get("sub")),
            "name": payload.get("name") or payload.get("preferred_username") or "",
            "email": payload.get("email") or "",
            # identity-provider avatar (standard OIDC `picture` claim);
            # the frontend renders it in the account button, falling
            # back to the initial monogram (reference parity:
            # app/static/js/app.js:108 avatar_url)
            "picture": payload.get("picture") or "",
        }
        meta.upsert_user(user["id"], user["name"], user["email"])
        # session rotation: fresh dict, nothing carried over
        req.session = {"user": user, "sid": secrets.token_urlsafe(16)}
        return Response.redirect(prefix + "/")

    @app.get(prefix + "/logout")
    async def logout(req: Request) -> Response:
        req.session = {}
        resp = Response.redirect(prefix + "/login")
        resp.delete_cookie(app.session_cookie)
        return resp


def current_user(req: Request) -> dict | None:
    return req.session.get("user")


def require_user(req: Request) -> dict | Response:
    user = current_user(req)
    if user is None:
        return Response.json({"error": "unauthorized"}, 401)
    return user
