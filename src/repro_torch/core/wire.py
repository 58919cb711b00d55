"""Wire formats: the dtype a chunk travels in, apart from the dtype the
optimizer state lives in (``repro/core/wire.py``, DESIGN.md §11).

  identity   the payload is the vector itself: the exchange is the
             pre-wire path, with no extra slot and the same kernels.
  bf16/f16   a down-cast payload (a cast, no kernel), no side data.
  int8       blockwise quantization per chunk: scale ``max|x| / 127``,
             payload ``round(x / scale)``, one f32 scale per chunk beside
             the payload; encoded by ``quantize_chunks`` and decoded by
             ``dequantize_chunks`` (``kernels/quant``).

An encoded exchange (``core/pipeline.py``) re-encodes the partial sum at
every ring hop and encodes the pull's parameter delta; what the rounding
drops from the delta is carried into the next step by the error-feedback
slot ``wire_ef``, an f32 slot laid out as momentum and appended last.

The ``hierarchical`` strategy has a second tier (``make_dcn_wire_format``,
``TrainConfig.wire_format_dcn``): the cross-pod leg may travel encoded
while the in-pod rings stay identity.  There is at most one ``wire_ef``
slot: an encoded ICI wire owns it for its pull delta (the DCN leg then runs
scales-only, without a residual), else an encoded DCN tier owns it for
each pod's push-side residual (``exchange_extra_slots``).

``pack_words``/``unpack_words`` frame a payload as uint32 words for the
collectives of ``core/comm.py::ProcessGroupComm`` (the int8 ring's hops,
the cross-pod gather and the pull), bitwise as the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..optim.protocol import SlotSpec

WIRE_FORMATS = ("identity", "bf16", "f16", "int8")

# the error-feedback residual slot: one per dtype group, float32, laid out
# as momentum; always the LAST slot of an exchange slot tuple
WIRE_EF_SLOT = "wire_ef"

_WIRE_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16,
                "int8": torch.int8}


@dataclass(frozen=True)
class WireFormat:
    """One wire encoding.  ``encode`` returns a tuple of wire tensors:
    ``(payload,)`` for the dtype-only wires, ``(payload, scales)`` for
    int8."""
    name: str

    def __post_init__(self):
        if self.name not in WIRE_FORMATS:
            raise ValueError(f"unknown wire format {self.name!r}; expected "
                             f"one of {WIRE_FORMATS}")

    @property
    def is_identity(self) -> bool:
        return self.name == "identity"

    @property
    def has_scales(self) -> bool:
        return self.name == "int8"

    @property
    def error_feedback(self) -> bool:
        """Non-identity wires carry the pull-delta residual slot."""
        return not self.is_identity

    def wire_dtype(self, state_dtype: torch.dtype) -> torch.dtype:
        return state_dtype if self.is_identity else _WIRE_DTYPES[self.name]

    def extra_slots(self) -> tuple[SlotSpec, ...]:
        """Exchange-level slots this wire adds to the optimizer's set."""
        if not self.error_feedback:
            return ()
        return (SlotSpec(WIRE_EF_SLOT, "float32"),)

    # ------------------------------------------------------- encode/decode

    def encode(self, x: torch.Tensor, chunk_elems: int) -> tuple:
        """Chunk-aligned (n,) float vector -> tuple of wire tensors."""
        if self.is_identity:
            return (x,)
        x = x.float()
        if not self.has_scales:
            return (x.to(_WIRE_DTYPES[self.name]),)
        if x.numel() % chunk_elems:
            raise ValueError(
                f"int8 wire encodes at chunk granularity: size {x.numel()} "
                f"is not a multiple of chunk_elems {chunk_elems}")
        from ..kernels.quant.ops import quantize_int8
        return quantize_int8(x, chunk_elems=chunk_elems)

    def decode(self, parts: tuple, chunk_elems: int) -> torch.Tensor:
        """Wire tuple -> (n,) float32 vector (identity: the payload)."""
        if self.is_identity:
            return parts[0]
        if not self.has_scales:
            return parts[0].float()
        from ..kernels.quant.ops import dequantize_int8
        q, scales = parts
        return dequantize_int8(q, scales, chunk_elems=chunk_elems)

    # ------------------------------------------------- collective word packing

    def pack_words(self, parts: tuple) -> tuple:
        """The narrow payload as uint32 words (a view: the same bytes, four
        int8 or two bf16/f16 codes a word, little-endian as the
        reference's ``bitcast_convert_type``); the scales and the identity
        payload as they are.  Payloads are whole chunks of a chunk size
        that is a multiple of the packing factor."""
        if self.is_identity:
            return parts
        q = parts[0]
        if q.element_size() < 4:
            q = q.contiguous().view(torch.uint32)
        return (q,) + tuple(parts[1:])

    def unpack_words(self, parts: tuple) -> tuple:
        """Inverse of ``pack_words`` (bitwise)."""
        q = parts[0]
        if not self.is_identity and q.dtype == torch.uint32:
            wdt = _WIRE_DTYPES[self.name]
            if wdt.itemsize < 4:
                q = q.view(wdt)
        return (q,) + tuple(parts[1:])

    # ------------------------------------------------------- byte accounting

    def payload_bytes(self, n_elems: int, state_dtype: torch.dtype,
                      chunk_elems: int) -> int:
        """Bytes ``n_elems`` of ``state_dtype`` occupy on the wire,
        including the per-chunk scale beside a quantized payload."""
        if n_elems <= 0:
            return 0
        b = n_elems * self.wire_dtype(state_dtype).itemsize
        if self.has_scales:
            b += -(-n_elems // chunk_elems) * 4        # one f32 scale/chunk
        return int(b)

    def compression_factor(self, state_dtype: torch.dtype,
                           chunk_elems: int) -> float:
        """raw_bytes / wire_bytes for one element stream (>= 1 saves)."""
        raw = state_dtype.itemsize * chunk_elems
        return raw / self.payload_bytes(chunk_elems, state_dtype,
                                        chunk_elems)


def make_wire_format(tc) -> WireFormat:
    """TrainConfig -> WireFormat (fails fast on unknown names)."""
    return WireFormat(name=tc.wire_format)


def make_dcn_wire_format(tc) -> WireFormat | None:
    """TrainConfig -> the cross-pod (DCN) tier's WireFormat, or None: both
    ``wire_format_dcn=None`` and ``"identity"`` mean no DCN tier (the
    cross-pod sum travels in the state dtype)."""
    name = tc.wire_format_dcn
    if name in (None, "identity"):
        return None
    return WireFormat(name=name)


def exchange_extra_slots(wire: WireFormat, wire_dcn=None
                         ) -> tuple[SlotSpec, ...]:
    """The exchange-level slots a (ICI wire, DCN wire) pair adds: at most
    one ``wire_ef``, appended last.  An encoded ICI wire owns it for the
    pull delta's residual (the DCN leg then runs scales-only); an
    identity ICI wire with an encoded DCN tier hands it to the DCN tier,
    which keeps each pod's push-side residual there."""
    if wire.error_feedback or wire_dcn is not None:
        return (SlotSpec(WIRE_EF_SLOT, "float32"),)
    return ()
