"""Seeded datasets: the port's copies of the reference package's
generators (``avenir_tpu/datagen/generators.py``: ``gen_telecom_churn``,
``gen_elearn``, ``gen_usage``, ``gen_transactions``,
``gen_state_sequences``, ``gen_hmm_sequences``, ``gen_retarget``,
``gen_hosp_readmit``, ``gen_visit_history``, ``gen_text_classified``,
``gen_event_seq``, ``gen_price_rounds``, ``gen_disease``,
``gen_xactions``, ``gen_numeric_classed``, and the click-through reward
simulator ``ctr_reward_sampler``) and of the presets that the runbooks
call (``avenir_tpu/datagen/cli.py``).

The same seed gives the same rows as the reference package's generators
(both draw from ``numpy.random.default_rng``).  Command line::

    python -m avenir_tpu_torch.datagen <preset> <sizes...> [--seed S] [--out FILE]

with the presets of :data:`PRESETS` (``transactions`` and
``timed_transactions`` take two sizes, transactions and items,
``xactions`` customers and days; the others one).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _clip_int(rng, mean, sd, lo, hi, size=None):
    v = np.rint(rng.normal(mean, sd, size)).astype(int)
    return np.clip(v, lo, hi)


def gen_telecom_churn(n: int, seed: int = 42) -> List[List[str]]:
    """Rows ``id,plan,minUsed,dataUsed,csCall,csEmail,network,churned``
    (resource/churn_nb/teleComChurn.json), ~20% churners from three
    planted causes: bad plan with heavy usage; excess customer-service
    contact; small network."""
    rng = np.random.default_rng(seed)
    rows = []
    min_usage = [(600, 50), (1200, 300)]
    data_usage = [(200, 50), (500, 150)]
    cs_call = [(4, 1), (8, 2)]
    cs_email = [(6, 2), (10, 3)]
    network = [(3, 1), (6, 2)]

    def draw(dist, i, lo, hi):
        m, s = dist[i]
        return int(_clip_int(rng, m, s, lo, hi))

    for i in range(n):
        cust_id = f"C{seed:02d}{i:07d}"
        churn = rng.integers(1, 100) > 80
        if churn:
            case = rng.integers(1, 4)
            churned = "Y"
            if case == 1:        # bad plan, heavy usage
                plan = "planA"
                mu = draw(min_usage, 1, 0, 2200)
                du = draw(data_usage, 1, 0, 1000)
                cc = draw(cs_call, 0, 0, 14)
                ce = draw(cs_email, 0, 0, 22)
                nw = draw(network, 0, 0, 12)
            elif case == 2:      # too many CS contacts
                plan = "planB"
                mu = draw(min_usage, 1, 0, 2200)
                du = draw(data_usage, 1, 0, 1000)
                cc = max(draw(cs_call, 1, 0, 14), 6)
                ce = max(draw(cs_email, 1, 0, 22), 8)
                nw = draw(network, 0, 0, 12)
            else:                # small network
                plan = "planB"
                mu = min(draw(min_usage, 1, 0, 2200) + 200, 2200)
                du = min(draw(data_usage, 1, 0, 1000) + 100, 1000)
                cc = draw(cs_call, 0, 0, 14)
                ce = draw(cs_email, 0, 0, 22)
                nw = draw(network, 0, 0, 12)
        else:
            churned = "N"
            plan = "planA" if rng.random() < 0.5 else "planB"
            p = 0 if plan == "planA" else 1
            mu = draw(min_usage, p, 0, 2200)
            du = draw(data_usage, p, 0, 1000)
            cc = min(draw(cs_call, 0, 0, 14), 2)
            ce = min(draw(cs_email, 0, 0, 22), 3)
            nw = draw(network, 1, 0, 12)
        rows.append([cust_id, plan, str(mu), str(du), str(cc), str(ce),
                     str(nw), churned])
    return rows


def gen_transactions(n_trans: int, n_items: int,
                     planted: Sequence[Sequence[int]] = ((3, 7, 11),),
                     planted_support: float = 0.2,
                     items_per_trans: Tuple[int, int] = (4, 10),
                     with_time: bool = False,
                     time_range: Tuple[int, int] = (1446336000, 1447545600),
                     seed: int = 42) -> List[List[str]]:
    """Market-basket rows ``transId, itemId, itemId, ...`` with planted
    frequent itemsets; with ``with_time`` an epoch-second timestamp is
    inserted at field 1 (the input of ``TemporalFilter``)."""
    rng = np.random.default_rng(seed)
    rows = []
    for t in range(n_trans):
        k = int(rng.integers(items_per_trans[0], items_per_trans[1] + 1))
        items = set(rng.integers(0, n_items, k).tolist())
        for pset in planted:
            if rng.random() < planted_support:
                items.update(pset)
        row = [f"T{t:06d}"] + [f"I{i:05d}" for i in sorted(items)]
        if with_time:
            row.insert(1, str(int(rng.integers(*time_range))))
        rows.append(row)
    return rows


def gen_state_sequences(n_seqs: int, states: Sequence[str],
                        trans_by_class: dict,
                        seq_len: Tuple[int, int] = (10, 30),
                        class_probs: Sequence[float] = None,
                        seed: int = 42) -> List[List[str]]:
    """Rows ``entityId, classLabel, s1, s2, ...`` from class-conditional
    Markov chains; ``trans_by_class`` maps a class label to a
    row-stochastic ``[S, S]`` matrix."""
    rng = np.random.default_rng(seed)
    classes = list(trans_by_class.keys())
    if class_probs is None:
        class_probs = [1.0 / len(classes)] * len(classes)
    S = len(states)
    rows = []
    for i in range(n_seqs):
        c = classes[rng.choice(len(classes), p=np.asarray(class_probs))]
        T = np.asarray(trans_by_class[c], dtype=float)
        L = int(rng.integers(seq_len[0], seq_len[1] + 1))
        s = int(rng.integers(0, S))
        seq = [states[s]]
        for _ in range(L - 1):
            s = int(rng.choice(S, p=T[s]))
            seq.append(states[s])
        rows.append([f"E{i:06d}", c] + seq)
    return rows


def gen_hmm_sequences(n_seqs: int, states: Sequence[str], obs: Sequence[str],
                      A: np.ndarray, B: np.ndarray, pi: np.ndarray,
                      seq_len: Tuple[int, int] = (8, 20),
                      seed: int = 42) -> List[List[str]]:
    """Fully tagged HMM rows ``entityId, obs1:state1, obs2:state2, ...``
    (the ``HiddenMarkovModelBuilder`` input)."""
    rng = np.random.default_rng(seed)
    A = np.asarray(A, float); B = np.asarray(B, float); pi = np.asarray(pi, float)
    rows = []
    for i in range(n_seqs):
        L = int(rng.integers(seq_len[0], seq_len[1] + 1))
        s = int(rng.choice(len(states), p=pi))
        pairs = []
        for t in range(L):
            o = int(rng.choice(len(obs), p=B[s]))
            pairs.append(f"{obs[o]}:{states[s]}")
            s = int(rng.choice(len(states), p=A[s]))
        rows.append([f"E{i:06d}"] + pairs)
    return rows


def _weighted_choice(rng, values_weights) -> str:
    values = [v for v, _ in values_weights]
    w = np.asarray([w for _, w in values_weights], dtype=float)
    return values[int(rng.choice(len(values), p=w / w.sum()))]


def gen_elearn(n: int, seed: int = 42) -> List[List[str]]:
    """E-learning rows: userId, nine activity features and a P/F status
    drawn from an accumulated fail probability (resource/elearn_nb)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        fail_prob = 10
        user_id = 1000000 + int(rng.integers(0, 1000001))
        content = max(int(rng.normal(300, 100)), 0)
        fail_prob += 10 if content < 100 else (6 if content < 150 else 0)
        discuss = max(int(rng.normal(80, 40)), 0)
        fail_prob += 8 if discuss < 30 else (4 if discuss < 50 else 0)
        organizer = max(int(rng.normal(40, 20)), 0)
        fail_prob += 5 if discuss < 10 else 0   # the reference checks discuss
        email = max(int(rng.normal(10, 6)), 0)
        fail_prob += 6 if email < 3 else 0
        test = int(np.clip(rng.normal(50, 30), 10, 100))
        fail_prob += 34 if test < 30 else (20 if test < 40 else
                                           (14 if test < 50 else 0))
        assign = int(np.clip(rng.normal(60, 40), 10, 100))
        fail_prob += 28 if assign < 35 else (18 if assign < 50 else
                                             (10 if assign < 60 else 0))
        chat = max(int(rng.normal(100, 60)), 0)
        fail_prob += 4 if chat < 20 else 0
        search = max(int(rng.normal(60, 40)), 0)
        fail_prob += 7 if search < 15 else (3 if search < 30 else 0)
        bookmarks = max(int(rng.normal(12, 8)), 0)
        fail_prob += 8 if bookmarks < 4 else 0
        status = "F" if rng.integers(0, 101) < fail_prob else "P"
        rows.append([str(user_id), str(content), str(discuss), str(organizer),
                     str(email), str(test), str(assign), str(chat),
                     str(search), str(bookmarks), status])
    return rows


def gen_usage(n: int, seed: int = 42) -> List[List[str]]:
    """Categorical account-usage rows: id, minute usage, data usage, CS
    calls, payment history, account age and status open/closed
    (resource/usage_churn_nb)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        uid = f"{int(rng.integers(10**11, 10**12))}"
        mins = _weighted_choice(rng, [("low", 2), ("med", 5), ("high", 3),
                                      ("overage", 2)])
        data = _weighted_choice(rng, [("low", 4), ("med", 6), ("high", 2)])
        cs = _weighted_choice(rng, [("low", 6), ("med", 3), ("high", 1)])
        pay = _weighted_choice(rng, [("poor", 2), ("average", 5), ("good", 4)])
        acct_age = int(rng.integers(4)) + 1
        pr = 25.0
        pr *= {"low": 1.2, "high": 1.4, "overage": 1.8}.get(mins, 1.0)
        pr *= {"low": 1.1, "med": 1.3, "high": 1.6}.get(data, 1.0)
        pr *= {"med": 1.2, "high": 1.6}.get(cs, 1.0)
        pr *= 1.3 if pay == "poor" else 1.0
        pr *= {3: 1.05, 4: 1.2}.get(acct_age, 1.0)
        pr = min(pr, 99.0)
        status = "closed" if rng.integers(100) < pr else "open"
        rows.append([uid, mins, data, cs, pay, str(acct_age), status])
    return rows


# the presets' model parameters (``avenir_tpu/datagen/cli.py``)
CHURN_STATES = ["LL", "LH", "HL", "HH"]
HMM_STATES = ["s0", "s1", "s2"]
HMM_OBS = ["a", "b", "c", "d"]
HMM_A = np.array([[.7, .2, .1], [.1, .7, .2], [.2, .1, .7]])
HMM_B = np.array([[.7, .1, .1, .1], [.1, .7, .1, .1], [.1, .1, .1, .7]])
HMM_PI = np.array([.5, .3, .2])
CHURN_CHAINS = {"L": np.full((4, 4), 0.25),
                "C": np.asarray([[0.1, 0.1, 0.1, 0.7]] * 4)}


def churn_state_seqs(n: int, seed: int = 42) -> List[List[str]]:
    """The churn_markov runbook's sequences: the loyal chain mixes its four
    states, the churner chain is absorbed into HH."""
    return gen_state_sequences(n, CHURN_STATES, CHURN_CHAINS,
                               seq_len=(15, 25), seed=seed)


def hmm_seqs(n: int, seed: int = 42) -> List[List[str]]:
    return gen_hmm_sequences(n, HMM_STATES, HMM_OBS, HMM_A, HMM_B, HMM_PI,
                             seed=seed)


def hmm_obs(n: int, seed: int = 67) -> List[List[str]]:
    """Observation-only rows (states stripped) for the Viterbi decoder."""
    return [[r[0]] + [p.split(":")[0] for p in r[1:]]
            for r in hmm_seqs(n, seed=seed)]


def transactions(n_trans: int, n_items: int, seed: int = 42):
    return gen_transactions(n_trans, n_items, planted=((3, 7, 11),),
                            planted_support=0.5, seed=seed)


def timed_transactions(n_trans: int, n_items: int, seed: int = 42):
    """Transactions with an epoch timestamp at field 1."""
    return gen_transactions(n_trans, n_items, planted=((3, 7, 11),),
                            planted_support=0.5, with_time=True, seed=seed)


def gen_blobs(n: int, seed: int = 41) -> List[List[str]]:
    """Rows ``id,x,y,cls`` (resource/knn_classify/blobs.json): two
    Gaussian blobs, class A around (0, 0) on even rows and class B around
    (8, 8) on odd rows."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        c = "A" if i % 2 == 0 else "B"
        cx = 0.0 if c == "A" else 8.0
        rows.append([f"E{i}", f"{cx + rng.normal():.3f}",
                     f"{cx + rng.normal():.3f}", c])
    return rows


RETARGET_CONVERSION = {"1C": 75, "1S": 60, "1N": 50, "2C": 60, "2S": 40,
                       "2N": 30, "3C": 20, "3S": 20, "3N": 15}


def gen_retarget(n: int, seed: int = 42) -> List[List[str]]:
    """Abandoned-shopping-cart retarget rows per resource/retarget.py:9-23:
    custID, retarget type (send hour 1/2/3 x recommendation C/S/N), cart
    amount, converted Y/N with the planted per-type conversion rates —
    the decision-tree / split-gain fixture."""
    rng = np.random.default_rng(seed)
    types = list(RETARGET_CONVERSION)
    rows = []
    for _ in range(n):
        cust = 1000000 + int(rng.integers(0, 1000000))
        t = types[int(rng.integers(9))]
        conv = "Y" if rng.integers(1, 101) < RETARGET_CONVERSION[t] else "N"
        amount = 20 + int(rng.integers(0, 301))
        rows.append([str(cust), t, str(amount), conv])
    return rows


def gen_hosp_readmit(n: int, seed: int = 42) -> List[List[str]]:
    """Hospital-readmission rows per resource/hosp_readmit.rb:5-99:
    patID, age, weight, height, employment, family status, diet, exercise,
    follow-up, smoking, alcohol, readmitted Y/N.  Age, living alone, and
    poor follow-up carry the strongest planted readmission signal — the MI
    feature-selection fixture (tutorial_hospital_readmit.txt:15-17)."""
    rng = np.random.default_rng(seed)
    age_d = [((10, 20), 2), ((21, 30), 3), ((31, 40), 6), ((41, 50), 10),
             ((51, 60), 14), ((61, 70), 19), ((71, 80), 25), ((81, 90), 21)]
    wt_d = [((130, 140), 9), ((141, 150), 13), ((151, 160), 16),
            ((161, 170), 20), ((171, 180), 23), ((181, 190), 20),
            ((191, 200), 17), ((201, 210), 14), ((211, 220), 10),
            ((221, 230), 7), ((231, 240), 5), ((241, 250), 3)]
    ht_d = [((50, 55), 9), ((56, 60), 12), ((61, 65), 16), ((66, 70), 23),
            ((71, 75), 14)]

    def ranged(dist):
        (lo, hi) = _weighted_choice(rng, [(r, w) for r, w in dist])
        return int(rng.integers(lo, hi + 1))

    rows = []
    for i in range(n):
        p = 20
        pid = f"{int(rng.integers(10**11, 10**12))}"
        age = ranged(age_d)
        p += 10 if age > 80 else (5 if age > 70 else (3 if age > 60 else 0))
        wt, ht = ranged(wt_d), ranged(ht_d)
        if wt > 200 and ht < 70:
            p += 5
        elif wt > 180 and ht < 60:
            p += 3
        emp = _weighted_choice(rng, [("employed", 10), ("unemployed", 1),
                                     ("retired", 3)])
        if age > 68 and rng.integers(10) < 8:
            emp = "retired"
        p += 6 if emp == "unemployed" else (4 if emp == "retired" else 0)
        fam = _weighted_choice(rng, [("alone", 10), ("withPartner", 15)])
        p += 9 if fam == "alone" else 0
        diet = _weighted_choice(rng, [("average", 10), ("poor", 4), ("good", 2)])
        if emp == "unemployed" and rng.integers(10) < 7:
            diet = "poor"
        p += 4 if diet == "poor" else (2 if diet == "average" else 0)
        ex = _weighted_choice(rng, [("average", 10), ("low", 12), ("high", 4)])
        p += 3 if ex == "low" else (1 if ex == "average" else 0)
        fup = _weighted_choice(rng, [("average", 10), ("low", 14), ("high", 3)])
        p += 8 if fup == "low" else (3 if fup == "average" else 0)
        smoke = _weighted_choice(rng, [("nonSmoker", 10), ("smoker", 3)])
        p += 6 if smoke == "smoker" else 0
        alco = _weighted_choice(rng, [("average", 10), ("low", 16), ("high", 4)])
        p += 5 if alco == "high" else (2 if alco == "average" else 0)
        readmit = "Y" if rng.integers(100) < p else "N"
        rows.append([pid, str(age), str(wt), str(ht), emp, fam, diet, ex,
                     fup, smoke, alco, readmit])
    return rows


def gen_visit_history(n: int, conv_rate: int = 30, label: bool = False,
                      seed: int = 42) -> List[List[str]]:
    """Site-visit session sequences per resource/visit_history.py:12-77:
    userID [, T/F conversion label], then session-summary states combining
    elapsed-time and duration letters (HL, MM, ...).  Converted users skew
    to short-elapsed / long-duration sessions — the PST / Markov sequence
    fixture."""
    rng = np.random.default_rng(seed)

    def state(conv: bool) -> str:
        s = int(rng.integers(0, 101))
        if conv:
            elapsed = "H" if s <= 15 else ("M" if s <= 40 else "L")
        else:
            elapsed = "L" if s <= 20 else ("M" if s <= 45 else "H")
        s = int(rng.integers(0, 101))
        if conv:
            duration = "L" if s <= 15 else ("M" if s <= 40 else "H")
        else:
            duration = "H" if s <= 20 else ("M" if s <= 45 else "L")
        return elapsed + duration

    rows = []
    for _ in range(n):
        uid = f"U{int(rng.integers(10**10, 10**11))}"
        row = [uid]
        converted = rng.integers(0, 101) < conv_rate
        if label:
            truth = rng.integers(0, 101) < 90
            row.append(("T" if truth else "F") if converted
                       else ("F" if truth else "T"))
        n_sess = int(rng.integers(2, 21 if converted else 13))
        row += [state(converted) for _ in range(n_sess)]
        rows.append(row)
    return rows


def gen_text_classified(n: int, seed: int = 42) -> List[List[str]]:
    """Short review texts with a planted sentiment signal for the Naive
    Bayes text mode (BayesianDistribution.java:187-196): positive rows draw
    mostly from a positive word pool, negative rows from a negative pool,
    both mixed with shared neutral filler.  Row = [text, classVal]."""
    rng = np.random.default_rng(seed)
    pos = ["excellent", "great", "fantastic", "loved", "wonderful", "superb"]
    neg = ["terrible", "awful", "broken", "refund", "worst", "disappointed"]
    neutral = ["product", "delivery", "box", "ordered", "arrived", "item",
               "week", "store", "price", "color"]
    rows = []
    for _ in range(n):
        positive = rng.random() < 0.5
        pool = pos if positive else neg
        k_sig = int(rng.integers(2, 5))
        k_neu = int(rng.integers(3, 8))
        words = [pool[rng.integers(len(pool))] for _ in range(k_sig)]
        words += [neutral[rng.integers(len(neutral))] for _ in range(k_neu)]
        rng.shuffle(words)
        rows.append([" ".join(words), "P" if positive else "N"])
    return rows


EVENT_SEQ_STATES = ["SL", "SS", "SM", "ML", "MS", "MM", "LL", "LS", "LM"]


def gen_event_seq(n: int, seed: int = 42) -> List[List[str]]:
    """Customer event sequences with planted locality bursts: about 30% of
    events are followed by a burst of 1-3 events from the same size group
    (same first letter).  The ``event_seq`` preset."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        cid = f"C{int(rng.integers(10**9, 10**10))}"
        events = []
        for _ in range(5 + int(rng.integers(20))):
            idx = int(rng.integers(len(EVENT_SEQ_STATES)))
            events.append(EVENT_SEQ_STATES[idx])
            if rng.integers(10) < 3:
                for _ in range(1 + int(rng.integers(3))):
                    idx = (idx // 3) * 3 + int(rng.integers(2))
                    events.append(EVENT_SEQ_STATES[idx])
        rows.append([cid] + events)
    return rows


def gen_price_rounds(n_products: int, n_prices: int = 5, seed: int = 42):
    """The bandit price-optimization fixture: each product has candidate
    prices with hidden mean profits.  Returns (price labels per product,
    the hidden mean reward matrix [product, price], a reward sampler)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(20, 100, n_products)
    prices = np.stack([base * (0.8 + 0.1 * k) for k in range(n_prices)],
                      axis=1)
    # the hidden best price index differs per product
    best = rng.integers(0, n_prices, n_products)
    mean_profit = np.empty((n_products, n_prices))
    for p in range(n_products):
        for k in range(n_prices):
            mean_profit[p, k] = (10.0 - 2.0 * abs(k - best[p])
                                 + rng.uniform(-0.5, 0.5))

    def sample_reward(product: int, price_idx: int, rng2=None) -> float:
        r = (rng2 or rng)
        return float(mean_profit[product, price_idx] + r.normal(0, 1.0))

    return prices, mean_profit, sample_reward


def gen_disease(n: int, seed: int = 42) -> List[List[str]]:
    """Disease-risk rows per resource/disease.rb:8-75: id, age, race,
    weight, diet, family history, domestic life, status Yes/No.  Risk
    multiplies up with age, AFA race, high-fat diet, family history, and
    living alone — the rule-mining fixture (tutorial_diesase_rule_mining)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        pid = f"{int(rng.integers(10**11, 10**12))}"
        age = 20 + int(rng.integers(60))
        race = _weighted_choice(rng, [("EUA", 10), ("AFA", 3), ("LAA", 1),
                                      ("ASA", 1)])
        weight = 120 + int(rng.integers(120))
        diet = _weighted_choice(rng, [("LF", 2), ("REG", 8), ("HF", 4)])
        fam = _weighted_choice(rng, [("NFH", 5), ("FH", 1)])
        dom = _weighted_choice(rng, [("S", 2), ("DP", 4)])
        pr = 15.0
        pr *= 1.0 if age < 40 else (1.05 if age < 50 else
                                    (1.15 if age < 60 else
                                     (1.4 if age < 70 else 1.5)))
        pr *= {"AFA": 1.2, "ASA": 0.9, "LAA": 0.95}.get(race, 1.0)
        pr *= 1.15 if diet == "HF" else 1.0
        pr *= 1.2 if fam == "FH" else 1.0
        pr *= 1.2 if dom == "S" else 1.0
        pr = min(pr, 99.0)
        status = "Yes" if rng.integers(100) < pr else "No"
        rows.append([pid, str(age), race, str(weight), diet, fam, dom, status])
    return rows


def gen_xactions(n_cust: int, n_days: int, visitor_percent: float = 0.05,
                 seed: int = 42) -> List[List[str]]:
    """Raw purchase transactions per resource/buy_xaction.rb:5-58:
    custID, xactionID, ISO date, amount.  Amounts alternate between small
    frequent and large infrequent purchases depending on days since the
    customer's previous transaction — the input to the state-conversion +
    Markov marketing-plan pipeline (mark_plan.rb)."""
    import datetime

    rng = np.random.default_rng(seed)
    cust_ids = [f"C{int(rng.integers(10**9, 10**10))}" for _ in range(n_cust)]
    hist = {}
    rows = []
    xid = 1360000000
    date = datetime.date(2013, 1, 1)
    for _ in range(n_days):
        n_x = int(visitor_percent * n_cust * (85 + int(rng.integers(30))) / 100)
        for _ in range(n_x):
            cid = cust_ids[int(rng.integers(len(cust_ids)))]
            if cid in hist:
                last_date, last_amt = hist[cid][-1]
                days = (date - last_date).days
                if days < 30:
                    amount = (50 + int(rng.integers(20)) - 10 if last_amt < 40
                              else 30 + int(rng.integers(10)) - 5)
                elif days < 60:
                    amount = (100 + int(rng.integers(40)) - 20 if last_amt < 80
                              else 60 + int(rng.integers(20)) - 10)
                else:
                    amount = (180 + int(rng.integers(60)) - 30 if last_amt < 150
                              else 120 + int(rng.integers(40)) - 20)
            else:
                hist[cid] = []
                amount = 40 + int(rng.integers(180))
            hist[cid].append((date, amount))
            xid += 1
            rows.append([cid, str(xid), date.isoformat(), str(amount)])
        date += datetime.timedelta(days=1)
    return rows


def ctr_reward_sampler(seed: int = 42):
    """Click-through-rate reward simulator per resource/lead_gen.py:12-66:
    three page actions with hidden Gaussian CTR distributions (page3 best).
    Returns (actions, sample(action) -> int reward) for driving the
    streaming RL loop the way the reference's Redis simulator does."""
    rng = np.random.default_rng(seed)
    distr = {"page1": (30, 12), "page2": (60, 30), "page3": (80, 10)}

    def sample(action: str) -> int:
        mean, sd = distr[action]
        # reference sums 12 uniform draws (Irwin-Hall approx of a Gaussian)
        s = int(sum(rng.integers(1, 100) for _ in range(12)))
        r = int(((s - 600) / 100.0) * sd + mean)
        return max(r, 0)

    return list(distr), sample


def gen_numeric_classed(n: int, n_features: int = 4, n_classes: int = 2,
                        sep: float = 2.0, seed: int = 42) -> List[List[str]]:
    """Generic numeric classification rows (id, f1..fk, class) with
    class-separated Gaussian features — fixture for logistic regression,
    Fisher discriminant, and kNN."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        c = int(rng.integers(0, n_classes))
        feats = rng.normal(c * sep, 1.0, n_features)
        rows.append([f"R{i:06d}"] + [f"{v:.3f}" for v in feats] + [f"C{c}"])
    return rows


def visit_history(n: int, seed: int = 42) -> List[List[str]]:
    """The ``visit_history`` preset: half the users convert, rows labelled."""
    return gen_visit_history(n, conv_rate=50, label=True, seed=seed)


# preset -> (generator, number of positional sizes)
PRESETS: Dict[str, tuple] = {
    "telecom_churn": (gen_telecom_churn, 1),
    "blobs": (gen_blobs, 1),
    "elearn": (gen_elearn, 1),
    "usage": (gen_usage, 1),
    "transactions": (transactions, 2),
    "timed_transactions": (timed_transactions, 2),
    "churn_state_seqs": (churn_state_seqs, 1),
    "hmm_seqs": (hmm_seqs, 1),
    "hmm_obs": (hmm_obs, 1),
    "retarget": (gen_retarget, 1),
    "hosp_readmit": (gen_hosp_readmit, 1),
    "visit_history": (visit_history, 1),
    "text_classified": (gen_text_classified, 1),
    "event_seq": (gen_event_seq, 1),
    "disease": (gen_disease, 1),
    "xactions": (gen_xactions, 2),
    "numeric_classed": (gen_numeric_classed, 1),
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    usage = ("usage: python -m avenir_tpu_torch.datagen <preset> <sizes...> "
             "[--seed S] [--out FILE]\npresets:\n  "
             + "\n  ".join(sorted(PRESETS)))
    if not argv or argv[0] not in PRESETS:
        print(usage, file=sys.stderr)
        return 2
    (fn, n_sizes), rest = PRESETS[argv[0]], argv[1:]
    seed, out, sizes = None, None, []
    try:
        i = 0
        while i < len(rest):
            if rest[i] == "--seed":
                seed = int(rest[i + 1]); i += 2
            elif rest[i] == "--out":
                out = rest[i + 1]; i += 2
            elif rest[i].startswith("--"):
                raise ValueError(f"unknown option {rest[i]}")
            else:
                sizes.append(int(rest[i])); i += 1
        if len(sizes) != n_sizes:
            raise ValueError(f"expected {n_sizes} size(s), got {len(sizes)}")
    except (IndexError, ValueError) as e:
        print(f"bad arguments: {e}\n{usage}", file=sys.stderr)
        return 2
    rows = fn(*sizes, **({} if seed is None else {"seed": seed}))
    text = "\n".join(",".join(r) for r in rows) + "\n"
    if out:
        d = os.path.dirname(out)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(out, "w") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
