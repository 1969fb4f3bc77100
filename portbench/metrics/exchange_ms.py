"""Exchange time a request: the program's ``rq.exchange`` spans
(parallel/sharded.permute_bits' rounds that cross the local/global
boundary: the local permutes and the block copies between shards), timed
by CUDA events on every card's stream, summed per card, the longest
card, averaged over the window's requests, in ms."""

from portbench import program_spans


def read(rec):
    requests = program_spans.window_requests(rec)
    if requests is None:
        return None
    per_request = []
    for r in requests:
        cards = {}
        for s in r.named("rq.exchange"):
            for card, ms in s.card_ms.items():
                cards[card] = cards.get(card, 0.0) + ms
        per_request.append(max(cards.values(), default=None))
    if all(v is None for v in per_request):
        return None
    return sum(v or 0.0 for v in per_request) / len(per_request)
