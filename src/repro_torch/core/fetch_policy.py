"""One validated knob-set for the client fetch path.

``EdgeClient`` historically took three loosely coupled flags —
``overlap`` (pipeline the suffix prefill against the transfer),
streamed-vs-blocking (implied by overlap + transport capability), and
directory-vs-transport (implied by the transport's type) — and the
illegal combinations only surfaced deep inside ``_fetch_streamed``.
``FetchPolicy`` collapses them into a single dataclass whose
constructor rejects contradictory combinations up front, so a gateway
or pool config maps 1:1 onto client behavior.

Transfer modes:

* ``"auto"``      — stream v3 chunks when the engine and the link both
                    support it, fall back to a blocking GET otherwise
                    (the old ``overlap=True`` behavior);
* ``"streamed"``  — require the layer-streamed path; construction fails
                    if the engine or any link cannot stream;
* ``"blocking"``  — never open a chunk stream (single-frame GETs only).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

TRANSFER_MODES = ("auto", "streamed", "blocking")


@dataclass(frozen=True)
class FetchPolicy:
    """Validated fetch-path configuration for :class:`EdgeClient`.

    ``overlap`` hides the partial-hit suffix prefill behind the blob
    transfer (sim accounting + real wall pipelining when streaming).
    ``use_catalog`` gates the Bloom-catalog probe (False = ablation:
    ask the server directly). ``upload_on_miss`` is the default for
    ``infer``'s per-call flag. ``min_match_tokens`` overrides the
    ``CacheConfig`` threshold when set.
    """
    transfer: str = "auto"
    overlap: bool = False
    use_catalog: bool = True
    upload_on_miss: bool = True
    min_match_tokens: Optional[int] = None

    def __post_init__(self):
        if self.transfer not in TRANSFER_MODES:
            raise ValueError(
                f"transfer={self.transfer!r} — expected one of "
                f"{TRANSFER_MODES}")
        if self.transfer == "blocking" and self.overlap:
            raise ValueError(
                "FetchPolicy(transfer='blocking', overlap=True) is "
                "contradictory: overlap pipelines the suffix prefill "
                "against a chunk stream, which 'blocking' forbids. Use "
                "transfer='auto' to overlap where the link allows it.")
        if self.transfer == "streamed" and not self.overlap:
            raise ValueError(
                "FetchPolicy(transfer='streamed', overlap=False) is "
                "contradictory: the layer-streamed fetch exists to "
                "overlap the suffix prefill with the download; a "
                "non-overlapped stream would buffer chunks for nothing. "
                "Set overlap=True or use transfer='auto'/'blocking'.")
        if self.min_match_tokens is not None and self.min_match_tokens < 0:
            raise ValueError("min_match_tokens must be >= 0")

    # ------------------------------------------------------------------
    def validate_for(self, engine, transports) -> None:
        """Construction-time capability check (strict modes only).

        ``transports`` is an iterable of transport-like objects (one per
        link in fabric mode, the single transport otherwise). In
        ``"streamed"`` mode every link must expose ``request_stream``
        and the engine must support layer streaming — failing here beats
        a silent fallback the caller explicitly opted out of.
        """
        if self.transfer != "streamed":
            return
        if not getattr(engine, "supports_layer_stream", False):
            raise ValueError(
                "FetchPolicy(transfer='streamed') but the engine does "
                "not support layer streaming (engine.supports_layer_"
                "stream is false)")
        bad = [t for t in transports if not hasattr(t, "request_stream")]
        if bad:
            raise ValueError(
                "FetchPolicy(transfer='streamed') but "
                f"{len(bad)} link(s) cannot stream (no request_stream): "
                f"{[type(t).__name__ for t in bad]}")
