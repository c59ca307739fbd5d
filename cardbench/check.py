"""What decides ``correct``: the run's outputs against the plain reference
(``reference/``), once the window has closed and the cluster is stopped.

Each check is a count that a sound run keeps at 0, and each has the limit 0:
- ``signer_mismatch``: every verdict of every window of the timed window
  against what the configuration states, that a triple verifies exactly
  when an honest replica signed it (the Byzantine replica corrupts every
  signature, and the honest ones sign theirs);
- ``rfc8032_mismatch``: a sample of those triples, drawn from the seed,
  verified by the plain RFC 8032 reference, against the card's verdicts;
- ``reply_unbacked``: sampled accepted replies without f + 1 distinct
  replicas whose reply carries the accepted result under a signature that
  the reference verifies over the reply's signed content;
- ``result_wrong``: accepted results other than the null operation's
  answer in the plain state machine;
- ``unanswered``: requests with no reply quorum by the drain's end;
- ``executed_not_once``: over the honest replicas, how far each one's
  executed count lies from the number of distinct requests sent;
- ``honest_disagree``: honest replicas whose executed sequence number or
  state digest differs from the primary's;
- ``items_minus_checks``: the service's items against the replicas'
  signature checks, over the cluster's life;
- ``fallback_items``, ``deadline_fired``, ``view_changes``: items the
  daemon served from its host fallback, verify deadlines the replicas
  fired, and view changes started.
"""

from __future__ import annotations

import hashlib
import json
import random
from typing import Dict, List, Tuple

from .reference import ed25519, state_machine

SAMPLE_ITEMS = 160
SAMPLE_BYZANTINE = 32


def reply_signable(reply: dict) -> bytes:
    """The 32-byte digest a replica signs for a reply: BLAKE2b-256 of the
    reply's canonical JSON (sorted keys, no spaces) without ``sig``, and
    without ``tentative`` when it is 0."""
    d = {k: v for k, v in reply.items() if k != "sig"}
    if not d.get("tentative"):
        d.pop("tentative", None)
    blob = json.dumps(d, sort_keys=True, separators=(",", ":")).encode()
    return hashlib.blake2b(blob, digest_size=32).digest()


def _reply_backed(sample: dict, pubs: List[bytes], f: int) -> bool:
    good = set()
    for r in sample["replies"]:
        rid = r.get("replica")
        if not isinstance(rid, int) or not 0 <= rid < len(pubs) or rid in good:
            continue
        if r.get("result") != sample["result"] or r.get("client") != sample["client"]:
            continue
        if r.get("timestamp") != sample["timestamp"]:
            continue
        try:
            sig = bytes.fromhex(r["sig"])
        except (KeyError, TypeError, ValueError):
            continue
        if ed25519.verify(pubs[rid], reply_signable(r), sig):
            good.add(rid)
        if len(good) >= f + 1:
            return True
    return False


def run_checks(*, seed: int, config: dict, secrets: List[bytes], windows: list, t0: float, t1: float,
               requests: List[dict], samples: List[dict], final: dict, start: dict,
               sent: int) -> Tuple[Dict[str, dict], dict]:
    """Each check's number and limit, and the counts behind them."""
    n, f = config["replicas"], config["f"]
    byzantine = set(config["byzantine"])
    honest = [i for i in range(n) if i not in byzantine]
    pubs = [ed25519.public_key(s) for s in secrets]
    honest_pubs = {pubs[i] for i in honest}

    timed = [w for w in windows if t0 <= w.start < t1]
    pairs = [(item, v) for w in timed for item, v in zip(w.items, w.verdicts)]
    signer_mismatch = sum(1 for (pub, _m, _s), v in pairs if bool(v) != (bytes(pub) in honest_pubs))

    rng = random.Random(seed)
    picked = rng.sample(range(len(pairs)), min(SAMPLE_ITEMS, len(pairs)))
    byz = [i for i, ((pub, _m, _s), _v) in enumerate(pairs) if bytes(pub) not in honest_pubs]
    picked += rng.sample(byz, min(SAMPLE_BYZANTINE, len(byz)))
    rfc_mismatch = sum(
        1 for i in picked
        if ed25519.verify(bytes(pairs[i][0][0]), bytes(pairs[i][0][1]), bytes(pairs[i][0][2])) != bool(pairs[i][1])
    )

    answer = state_machine.NullService().execute("")
    reply_unbacked = sum(1 for s in samples if not _reply_backed(s, pubs, f))
    result_wrong = sum(1 for s in samples if s["result"] != answer)

    reps = final["replicas"]
    executed_not_once = sum(abs(int(reps[i].get("executed", 0)) - sent) for i in honest)
    ref_state = (reps[honest[0]].get("executed_upto"), reps[honest[0]].get("state_digest"))
    honest_disagree = sum(1 for i in honest if (reps[i].get("executed_upto"), reps[i].get("state_digest")) != ref_state)
    checks_sum = sum(int(r.get("sig_verified", 0)) + int(r.get("sig_rejected", 0)) for r in reps)
    service_items = final["service"]["items"] - start["service"]["items"]
    values = {
        "signer_mismatch": signer_mismatch,
        "rfc8032_mismatch": rfc_mismatch,
        "reply_unbacked": reply_unbacked,
        "result_wrong": result_wrong,
        "unanswered": sum(1 for r in requests if r["quorum"] is None),
        "executed_not_once": executed_not_once,
        "honest_disagree": honest_disagree,
        "items_minus_checks": abs(service_items - checks_sum),
        "fallback_items": final["service"].get("fallback_items", 0),
        "deadline_fired": sum(int(r.get("verify_deadline_fired", 0)) for r in reps),
        "view_changes": sum(int(r.get("view_changes_started", 0)) for r in reps),
    }
    counts = {"items_in_window": len(pairs), "items_sampled": len(picked), "replies_sampled": len(samples)}
    return {k: {"value": v, "limit": 0} for k, v in values.items()}, counts
