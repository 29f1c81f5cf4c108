"""Environment-driven configuration.

Capability parity with the reference's ``app/config.py`` (reference
``app/config.py:1-270``): every runtime knob comes from the environment with a
sensible default, including the retrieval parameters (``VECTOR_DIM=1024``,
``TOP_K=12``, ``RERANK_K``, ``REFRESH_BATCH_SIZE`` — reference
``app/config.py:8,253-255``), the chat-model catalog with per-model sampling
defaults and beta gating (reference ``app/config.py:35-91``), the persona
system prompts and the classifier-router prompt (reference
``app/config.py:107-235``), OIDC and Outline settings.

TPU-specific additions (no reference equivalent): index dtype/quantization
mode, shard capacity, mesh axis sizes, encoder model dimensions and bucketing.

Everything is collected into one frozen :class:`Settings` dataclass built by
:func:`load_settings` so tests can construct configs without touching the
process environment.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any


# --------------------------------------------------------------------------
# Default chat-model catalog.
#
# Same *shape* as the reference catalog (reference ``app/config.py:35-91``):
# a JSON list of entries with id / label / provider params / sampling
# defaults / capability flags / optional beta gating.  The concrete entries
# are generic defaults; deployments override via CHAT_MODELS_JSON.
# --------------------------------------------------------------------------
_DEFAULT_CHAT_MODELS: list[dict[str, Any]] = [
    {
        "id": "deepseek-v3",
        "label": "DeepSeek V3",
        "provider_model": "deepseek-ai/DeepSeek-V3",
        "temperature": 0.7,
        "top_p": 0.9,
        "supports_thinking": False,
        "beta": False,
    },
    {
        "id": "deepseek-r1",
        "label": "DeepSeek R1 (thinking)",
        "provider_model": "deepseek-ai/DeepSeek-R1",
        "temperature": 0.6,
        "top_p": 0.95,
        "supports_thinking": True,
        "beta": False,
    },
    {
        "id": "qwen-72b",
        "label": "Qwen 2.5 72B",
        "provider_model": "Qwen/Qwen2.5-72B-Instruct",
        "temperature": 0.7,
        "top_p": 0.8,
        "supports_thinking": False,
        "beta": True,
    },
]

# Persona system prompts (reference defines Query / Creative / Roleplay /
# General personas plus a shared worldview preamble, ``app/config.py:93-154``).
_DEFAULT_WORLDVIEW = (
    "You are the knowledge assistant for this team's Outline wiki. Answer "
    "from the retrieved wiki context when it is relevant, and be explicit "
    "when the context does not cover the question."
)

_DEFAULT_PROMPTS = {
    "Query": (
        "{worldview}\n\n"
        "Answer the user's question using ONLY the numbered context excerpts "
        "below. Cite the excerpts you used with bracketed markers like "
        "[source 1]. If the context is insufficient, say so plainly instead "
        "of guessing.\n\nContext:\n{context}"
    ),
    "Creative": (
        "{worldview}\n\n"
        "The user wants creative writing grounded in the wiki's setting. Use "
        "the context excerpts below for facts and tone, cite with [source n] "
        "where you rely on them, and invent freely where they are silent.\n\n"
        "Context:\n{context}"
    ),
    "Roleplay": (
        "{worldview}\n\n"
        "Stay in character as requested by the user. Ground character and "
        "world facts in the context excerpts below, citing [source n] for "
        "factual claims.\n\nContext:\n{context}"
    ),
    "General": (
        "{worldview}\n\n"
        "Answer the user's question directly. No wiki context was retrieved "
        "for this turn."
    ),
}

# Classifier-router prompt: JSON-mode single-label classification of the user
# turn into one of the persona routes (reference ``app/config.py:158-235``).
_DEFAULT_CLASSIFIER_PROMPT = (
    "Classify the user's latest message into exactly one category:\n"
    '- "Query": asks for factual information that the team wiki may contain\n'
    '- "Creative": asks for creative writing set in the wiki\'s world\n'
    '- "Roleplay": asks you to act as a character\n'
    '- "General": anything else (greetings, meta questions, chit-chat)\n\n'
    "Recent conversation:\n{history}\n\nUser message:\n{question}\n\n"
    'Respond with JSON only: {{"category": "<one of Query|Creative|Roleplay|'
    'General>"}}'
)

_DEFAULT_REWRITE_PROMPT = (
    "Given the conversation history and the user's latest message, rewrite "
    "the message as a single self-contained search query. Resolve pronouns "
    "and references using the history. Output only the rewritten query.\n\n"
    "History:\n{history}\n\nMessage: {question}"
)

_DEFAULT_ANSWER_TEMPLATE = (
    "{question}"
)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One entry of the chat-model catalog."""

    id: str
    label: str
    provider_model: str
    temperature: float = 0.7
    top_p: float = 0.9
    supports_thinking: bool = False
    beta: bool = False
    # optional icon URL for the catalog entry (reference `modelConf.icon`
    # override, core.js:86); empty -> the frontend's generated monogram
    icon: str = ""

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ModelSpec":
        return cls(
            id=str(d["id"]),
            label=str(d.get("label", d["id"])),
            provider_model=str(d.get("provider_model", d["id"])),
            temperature=float(d.get("temperature", 0.7)),
            top_p=float(d.get("top_p", 0.9)),
            supports_thinking=bool(d.get("supports_thinking", False)),
            beta=bool(d.get("beta", False)),
            icon=str(d.get("icon", "")),
        )


@dataclasses.dataclass(frozen=True)
class Settings:
    # --- identity / serving ---
    app_name: str = "Outline RAG (TPU)"
    host: str = "0.0.0.0"
    port: int = 8000
    secret_key: str = ""
    session_max_age: int = 7 * 24 * 3600  # 7-day cookie, reference main.py:160
    url_prefix: str = "/chat"

    # --- storage ---
    database_url: str = ""  # empty -> sqlite file under data_dir
    redis_url: str = ""  # empty -> in-process bus
    data_dir: str = "./data"
    attachments_dir: str = "./data/attachments"
    upload_max_bytes: int = 5 * 1024 * 1024
    upload_allowed_exts: tuple[str, ...] = ("txt", "md", "pdf")

    # --- Outline integration ---
    outline_api_url: str = ""
    outline_api_token: str = ""
    outline_webhook_secret: str = ""
    outline_webhook_sign: bool = True
    outline_collections: tuple[str, ...] = ()

    # --- LLM provider (chat stays a provider call; see SURVEY.md section 2b) ---
    llm_api_base: str = ""
    llm_api_key: str = ""
    base_chat_model: str = "deepseek-v3"
    chat_models: tuple[ModelSpec, ...] = ()
    beta_user_ids: tuple[str, ...] = ()

    # --- prompts ---
    worldview: str = _DEFAULT_WORLDVIEW
    persona_prompts: dict[str, str] = dataclasses.field(
        default_factory=lambda: dict(_DEFAULT_PROMPTS)
    )
    classifier_prompt: str = _DEFAULT_CLASSIFIER_PROMPT
    rewrite_prompt: str = _DEFAULT_REWRITE_PROMPT
    answer_template: str = _DEFAULT_ANSWER_TEMPLATE
    max_history_messages: int = 20  # reference config.py:239

    # --- retrieval core ---
    vector_dim: int = 1024  # reference config.py:8
    top_k: int = 12  # candidates, reference config.py:253
    rerank_k: int = 3  # kept after rerank, reference config.py:254
    chunk_size: int = 1024  # characters, reference rag.py:113
    chunk_overlap: int = 100  # reference rag.py:114
    refresh_batch_size: int = 100  # reference config.py:255
    webhook_debounce_s: float = 60.0  # reference api.py:1025
    sse_ping_interval_s: float = 20.0  # reference api.py:736

    # --- TPU engine (new; no reference equivalent) ---
    # int8r (default: two-plane int8 — quantized scan bandwidth with
    # fp32-oracle-EXACT ranking, measured agreement@12 = 1.0 at
    # 10k/100k/1M on chip, EVAL_r05.json; quarter the f32 bytes on the
    # scanned plane) | float32 (exact by construction, HIGHEST
    # scoring) | f32x2 (compensated bf16 pairs, exact, f32 bytes) |
    # bfloat16 | int8 (fastest scan, ~0.98-0.99 top-12 agreement)
    index_dtype: str = "int8r"
    # snapshot restore/persist: at startup the app adopts
    # {data_dir}/index_snapshot(.npz) when present (instant restart —
    # the delta-sync protocol reconciles any staleness on the next
    # refresh); >0 autosaves the snapshot every N seconds when the
    # index generation changed (plus once at graceful shutdown)
    index_autosave_s: float = 0.0
    shard_capacity: int = 1 << 17  # rows per device shard (power of two)
    mesh_data_axis: int = 0  # 0 -> use all local devices
    encoder_model: str = "bge-m3"
    token_width: int = 64  # device token-cache width (fused rerank path)
    encoder_max_tokens: int = 512
    encoder_weights_path: str = ""  # empty -> deterministic fallback embedder
    reranker_weights_path: str = ""
    # w8a8 int8 encoder/reranker trunks (models/encoder.py::
    # quantize_encoder_params): ~2x MXU throughput on the serving path's
    # biggest compute bills (query encode + B*K rerank pairs); score
    # heads stay full-precision. Opt-in pending measured recall deltas.
    encoder_int8: bool = False
    # Llama/Qwen-family checkpoint for fully-local generation (the chat
    # provider runs on-TPU instead of calling an OpenAI-compatible API)
    decoder_weights_path: str = ""
    decoder_max_new_tokens: int = 512
    decoder_batch_slots: int = 0  # >1 -> continuous batching across chats
    decoder_int8: bool = False  # int8 decoder weights (fused VMEM dequant)
    decoder_int4: bool = False  # int4 w4a16 group-quantized decoder weights
    # >0 -> prompt-lookup speculative decoding with this many draft
    # tokens per verify step (output is distribution-identical; RAG
    # answers quote retrieved context, so acceptance is high)
    decoder_spec_k: int = 0
    decoder_spec_gram: int = 3  # n-gram width of the draft lookup
    # >0 -> the continuous batcher's KV lives in a shared pool of this
    # many pages (paged attention): HBM scales with live sequence
    # lengths, admission waits for pages instead of reserving worst case
    decoder_kv_pages: int = 0
    decoder_page_size: int = 128
    # paged mode: content-address full prompt pages and share them across
    # requests (automatic prefix caching; exact — warm == cold bit-wise)
    decoder_prefix_cache: bool = True
    # paged mode: int8 KV pool — half the KV HBM, 2x live context/chip
    decoder_kv_int8: bool = False
    # >1: Megatron-TP decode over that many devices (parallel/tp.py)
    decoder_tp: int = 0
    # graceful-shutdown drain window for in-flight requests/streams
    drain_timeout: float = 10.0
    query_batch_window_ms: float = 4.0
    query_batch_max: int = 32
    lex_weight: float = 0.0  # >0 blends BGE-m3 lexical overlap into retrieval
    colbert_weight: float = 0.0  # >0 blends BGE-m3 ColBERT late interaction
    # >0 caches projected int8 per-token ColBERT vectors on the index so
    # late interaction gathers instead of re-encoding candidates
    # (HBM cost: capacity * token_width * (rank + 4) bytes)
    colbert_cache_rank: int = 0

    # --- OIDC (reference blueprints/auth.py) ---
    oidc_issuer: str = ""
    oidc_client_id: str = ""
    oidc_client_secret: str = ""
    oidc_redirect_url: str = ""

    # --- observability ---
    log_level: str = "INFO"
    safe_log_chat_input: bool = True
    max_log_input_chars: int = 120

    def model_by_id(self, model_id: str) -> ModelSpec | None:
        for m in self.chat_models:
            if m.id == model_id:
                return m
        return None

    def visible_models(self, user_id: str | None) -> list[ModelSpec]:
        """Catalog filtered by beta allowlist (reference api.py:161-175)."""
        return [
            m
            for m in self.chat_models
            if not m.beta or (user_id is not None and user_id in self.beta_user_ids)
        ]


def _parse_models(raw: str) -> tuple[ModelSpec, ...]:
    data = json.loads(raw) if raw else _DEFAULT_CHAT_MODELS
    return tuple(ModelSpec.from_dict(d) for d in data)


def load_settings(env: dict[str, str] | None = None) -> Settings:
    """Build Settings from ``env`` (defaults to ``os.environ``).

    Reads the mapping directly — never mutates ``os.environ`` — so it is
    safe to call while other threads read the process environment.
    """
    src = os.environ if env is None else dict(env)

    def _env(key: str, default: str = "") -> str:
        return src.get(key, default)

    def _env_int(key: str, default: int) -> int:
        raw = src.get(key)
        return default if raw is None or raw == "" else int(raw)

    def _env_float(key: str, default: float) -> float:
        raw = src.get(key)
        return default if raw is None or raw == "" else float(raw)

    def _env_bool(key: str, default: bool = False) -> bool:
        raw = src.get(key)
        if raw is None or raw == "":
            return default
        return raw.strip().lower() in ("1", "true", "yes", "on")

    models = _parse_models(_env("CHAT_MODELS_JSON"))
    persona = dict(_DEFAULT_PROMPTS)
    for key in list(persona):
        override = _env(f"PROMPT_{key.upper()}")
        if override:
            persona[key] = override
    return Settings(
        app_name=_env("APP_NAME", "Outline RAG (TPU)"),
        host=_env("HOST", "0.0.0.0"),
        port=_env_int("PORT", 8000),
        secret_key=_env("SECRET_KEY"),
        session_max_age=_env_int("SESSION_MAX_AGE", 7 * 24 * 3600),
        url_prefix=_env("URL_PREFIX", "/chat"),
        database_url=_env("DATABASE_URL"),
        redis_url=_env("REDIS_URL"),
        data_dir=_env("DATA_DIR", "./data"),
        attachments_dir=_env(
            "ATTACHMENTS_DIR",
            (os.path.join(_env("DATA_DIR", "./data"), "attachments")
             if _env("DATA_DIR", "./data") else "./data/attachments"),
        ),
        upload_max_bytes=_env_int("UPLOAD_MAX_BYTES", 5 * 1024 * 1024),
        outline_api_url=_env("OUTLINE_API_URL"),
        outline_api_token=_env("OUTLINE_API_TOKEN"),
        outline_webhook_secret=_env("OUTLINE_WEBHOOK_SECRET"),
        outline_webhook_sign=_env_bool("OUTLINE_WEBHOOK_SIGN", True),
        outline_collections=tuple(
            c for c in _env("OUTLINE_COLLECTIONS").split(",") if c
        ),
        llm_api_base=_env("LLM_API_BASE"),
        llm_api_key=_env("LLM_API_KEY"),
        base_chat_model=_env("BASE_CHAT_MODEL", "deepseek-v3"),
        chat_models=models,
        beta_user_ids=tuple(
            u for u in _env("BETA_AUTHORIZED_USER_IDS").split(",") if u
        ),
        worldview=_env("CORE_WORLDVIEW", _DEFAULT_WORLDVIEW),
        persona_prompts=persona,
        classifier_prompt=_env("CLASSIFIER_PROMPT", _DEFAULT_CLASSIFIER_PROMPT),
        rewrite_prompt=_env("REWRITE_PROMPT", _DEFAULT_REWRITE_PROMPT),
        answer_template=_env("ANSWER_TEMPLATE", _DEFAULT_ANSWER_TEMPLATE),
        max_history_messages=_env_int("MAX_HISTORY_MESSAGES", 20),
        vector_dim=_env_int("VECTOR_DIM", 1024),
        top_k=_env_int("TOP_K", 12),
        rerank_k=_env_int("RERANK_K", _env_int("K", 3)),
        chunk_size=_env_int("CHUNK_SIZE", 1024),
        chunk_overlap=_env_int("CHUNK_OVERLAP", 100),
        refresh_batch_size=_env_int("REFRESH_BATCH_SIZE", 100),
        webhook_debounce_s=_env_float("WEBHOOK_DEBOUNCE_S", 60.0),
        sse_ping_interval_s=_env_float("SSE_PING_INTERVAL_S", 20.0),
        index_dtype=_env("INDEX_DTYPE", "int8r"),
        index_autosave_s=_env_float("INDEX_AUTOSAVE_S", 0.0),
        shard_capacity=_env_int("SHARD_CAPACITY", 1 << 17),
        mesh_data_axis=_env_int("MESH_DATA_AXIS", 0),
        encoder_model=_env("ENCODER_MODEL", "bge-m3"),
        token_width=_env_int("TOKEN_WIDTH", 64),
        encoder_max_tokens=_env_int("ENCODER_MAX_TOKENS", 512),
        encoder_weights_path=_env("ENCODER_WEIGHTS_PATH"),
        reranker_weights_path=_env("RERANKER_WEIGHTS_PATH"),
        encoder_int8=_env_bool("ENCODER_INT8", False),
        decoder_weights_path=_env("DECODER_WEIGHTS_PATH"),
        decoder_max_new_tokens=_env_int("DECODER_MAX_NEW_TOKENS", 512),
        decoder_batch_slots=_env_int("DECODER_BATCH_SLOTS", 0),
        decoder_int8=_env_bool("DECODER_INT8", False),
        decoder_int4=_env_bool("DECODER_INT4", False),
        decoder_spec_k=_env_int("DECODER_SPEC_K", 0),
        decoder_spec_gram=_env_int("DECODER_SPEC_GRAM", 3),
        decoder_kv_pages=_env_int("DECODER_KV_PAGES", 0),
        decoder_page_size=_env_int("DECODER_PAGE_SIZE", 128),
        decoder_prefix_cache=_env_bool("DECODER_PREFIX_CACHE", True),
        decoder_kv_int8=_env_bool("DECODER_KV_INT8", False),
        decoder_tp=_env_int("DECODER_TP", 0),
        drain_timeout=_env_float("DRAIN_TIMEOUT", 10.0),
        query_batch_window_ms=_env_float("QUERY_BATCH_WINDOW_MS", 4.0),
        query_batch_max=_env_int("QUERY_BATCH_MAX", 32),
        lex_weight=_env_float("LEX_WEIGHT", 0.0),
        colbert_weight=_env_float("COLBERT_WEIGHT", 0.0),
        # Cache defaults ON when ColBERT is enabled: the un-cached path
        # re-encodes candidates (~-34% measured) while r=128 codes are
        # measured-free at query time. Explicit COLBERT_CACHE_RANK=0 opts out.
        colbert_cache_rank=_env_int(
            "COLBERT_CACHE_RANK",
            128 if _env_float("COLBERT_WEIGHT", 0.0) > 0 else 0,
        ),
        oidc_issuer=_env("OIDC_ISSUER"),
        oidc_client_id=_env("OIDC_CLIENT_ID"),
        oidc_client_secret=_env("OIDC_CLIENT_SECRET"),
        oidc_redirect_url=_env("OIDC_REDIRECT_URL"),
        log_level=_env("LOG_LEVEL", "INFO"),
        safe_log_chat_input=_env_bool("SAFE_LOG_CHAT_INPUT", True),
        max_log_input_chars=_env_int("MAX_LOG_INPUT_CHARS", 120),
    )