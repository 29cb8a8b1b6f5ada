"""repro_torch.comm — the one-shot communication substrate.

wire.py     versioned wire format + codec registry (fp32 / fp16 / int8 /
            topk): ``len(encode(obj, codec))`` is the exact cost
ledger.py   ``CommLedger``: every protocol message as a typed
            ``CommEvent`` at its exact size, or (``compact=True``) as
            per-tag counts and byte totals in fixed memory
exchange.py ``ModelExchange``: price each model once, pick under the
            budget, evaluate the decoded models; ``StreamExchange``:
            its streaming twin, selection over ``ReportColumns``,
            shape-priced budgets, models regenerated on demand
budget.py   budget-constrained selection: strategy-rank greedy knapsack
channel.py  per-device uplink model (lognormal bandwidth, drops, round
            deadlines); ``ChannelStream`` derives every device's draws
            lazily from its device seed
"""
from repro_torch.comm.budget import BudgetedSelection, budgeted_select, pack_ranked
from repro_torch.comm.channel import (
    ChannelModel,
    ChannelStream,
    calibrated_deadline,
    make_channel,
    make_channel_stream,
)
from repro_torch.comm.exchange import ModelExchange, StreamExchange
from repro_torch.comm.ledger import CommEvent, CommLedger
from repro_torch.comm.wire import (
    CODECS,
    Codec,
    QuantizedStackedEnsemble,
    QuantizedSVM,
    REPORT_NBYTES,
    WIRE_VERSION,
    decode,
    encode,
    encoded_nbytes,
    get_codec,
    payload_to_tree,
    svm_wire_nbytes,
    tree_to_payload,
)

__all__ = [
    "BudgetedSelection", "budgeted_select", "pack_ranked",
    "ChannelModel", "ChannelStream", "calibrated_deadline",
    "make_channel", "make_channel_stream",
    "CommEvent", "CommLedger", "ModelExchange", "StreamExchange",
    "CODECS", "Codec", "QuantizedStackedEnsemble", "QuantizedSVM",
    "REPORT_NBYTES", "WIRE_VERSION",
    "decode", "encode", "encoded_nbytes", "get_codec", "payload_to_tree",
    "svm_wire_nbytes", "tree_to_payload",
]
