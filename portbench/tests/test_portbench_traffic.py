"""The traffic generators: the same seed gives the same traffic, every seed
the same set of sizes and gaps, and the draws stay in the mix's ranges."""

from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import load_json, load_module

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
open_asks = load_module(TRAFFIC / "open_asks.py")
closed_chats = load_module(TRAFFIC / "closed_chats.py")


def test_open_asks_schedule_is_fixed_by_the_seed_and_shares_its_gaps():
    mix = load_json(TRAFFIC / "asks.poisson.json")
    due_a, qs_a = open_asks.schedule(mix, 2**31 + 17, 20.0)
    due_b, qs_b = open_asks.schedule(mix, 2**31 + 17, 20.0)
    due_c, qs_c = open_asks.schedule(mix, 5, 20.0)
    assert np.array_equal(due_a, due_b) and qs_a == qs_b
    assert qs_a != qs_c
    gaps_a, gaps_c = np.diff(due_a), np.diff(due_c)
    # the same set of gaps in another order (the first gap of each is dropped by diff)
    assert abs(np.sort(gaps_a).mean() - np.sort(gaps_c).mean()) < 0.05 / mix["rate_per_s"]
    n = round(mix["rate_per_s"] * (mix["lead_s"] + 20.0))
    assert len(due_a) == n and len(set(qs_a)) == n
    assert due_a[0] == pytest.approx(-mix["lead_s"]) and due_a[-1] < 20.0
    assert np.all(np.diff(due_a) > 0)
    lengths = Counter(len(q.split()) for q in qs_a)
    lo, hi = mix["question_words"]
    assert min(lengths) == lo and max(lengths) == hi
    assert Counter(len(q.split()) for q in qs_c) == lengths


def test_open_asks_offer_the_rate():
    mix = dict(load_json(TRAFFIC / "asks.poisson.json"), rate_per_s=50.0, lead_s=0.0)
    due, _ = open_asks.schedule(mix, 11, 40.0)
    assert len(due) == 2000
    # Poisson in shape: the gaps' coefficient of variation is about 1
    gaps = np.diff(due)
    assert 0.9 < gaps.std() / gaps.mean() < 1.1


@pytest.mark.parametrize("name", ["chats.rag", "chats.general"])
def test_closed_chats_sizes_are_one_set_in_the_seeds_order(name):
    mix = load_json(TRAFFIC / f"{name}.json")
    q_a, a_a = closed_chats.sizes(mix, 3)
    q_b, a_b = closed_chats.sizes(mix, 2**31 + 3)
    assert sorted(q_a) == sorted(q_b) and sorted(a_a) == sorted(a_b)
    assert (q_a, a_a) != (q_b, a_b)
    assert (q_a, a_a) == closed_chats.sizes(mix, 3)
    assert min(q_a) == mix["question_words"][0] and max(q_a) == mix["question_words"][1]
    assert mix["answer_tokens"][0] <= min(a_a) and max(a_a) <= mix["answer_tokens"][1]
    assert abs(float(np.median(a_a)) - mix["answer_median"]) <= 0.05 * mix["answer_median"]


def test_a_chat_is_fixed_by_seed_and_index():
    mix = load_json(TRAFFIC / "chats.rag.json")
    s = closed_chats.sizes(mix, 9)
    one = closed_chats.chat(mix, 9, 7, s, 151_936)
    assert one == closed_chats.chat(mix, 9, 7, s, 151_936)
    assert one != closed_chats.chat(mix, 9, 8, s, 151_936)
    greedy = [closed_chats.chat(mix, 9, i, s, 151_936)["greedy"] for i in range(40)]
    assert sum(greedy) == 40 // mix["greedy_every"]
    text = closed_chats.chunk_text(9, 123, mix["chunk_words"], 151_936)
    assert text == closed_chats.chunk_text(9, 123, mix["chunk_words"], 151_936)
    assert mix["chunk_words"][0] <= len(text.split()) <= mix["chunk_words"][1]
