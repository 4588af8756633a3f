"""Node states of the ring's block domain kept on the shards' cards (the
JAX package's O(V/n) node-state memory under permuted IO:
ultra_torchdrug_tpu/parallel/ring_rspmm.py's ``permuted_io`` and
ultra_torchdrug_tpu/parallel/DESIGN.md §1).

The ring (parallel/ring_rspmm.py) splits the node rows into n blocks of
v_block rows, block s owned by shard s on ``devices[s]`` (parallel/mesh.py).
``CardRows`` holds a data row's state [n * v_block, F] as one tensor a
card: the rows of that card's shards in shard order (``card_groups``; the
shards share cards in turn under ``shard_cards``, so edge 4 on 2 cards
puts shards 0 and 2 on card 0). The entity tower keeps its states so from
the boundary to the readout: the ring ops take and return the cards'
tensors, and every row-wise op between convs runs once a card
(``CardRows.map``), so no [n * v_block, F] state is formed on the home.
With every shard on one device there is one tensor, the block-domain state
itself, and the operations are those of a home tensor.

``CardLayout.cut`` and ``join`` move a home tensor's rows to the cards and
back (differentiable copies); the tower uses them only for per-row
constants (degrees, PNA's scalers) and the score columns, and the ring ops
for callers that pass a home tensor (``CardRows.from_home``,
``to_home``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import torch

from .placement import blocks_on, replicate


def card_groups(devices: Sequence) -> tuple:
    """The grouping rule: the shards of each distinct device of
    ``devices`` (shard s on ``devices[s]``) in shard order, the devices in
    the order of their first shard, so that card 0 holds shard 0."""
    groups = {}
    for s, d in enumerate(devices):
        groups.setdefault(d, []).append(s)
    return tuple(tuple(g) for g in groups.values())


@dataclasses.dataclass(frozen=True)
class CardLayout:
    """Where a data row's block-domain rows live: shard s's v_block rows
    on ``devices[s]``, each card c holding the shards ``groups[c]``, in
    that order, as one tensor."""

    devices: tuple
    v_block: int
    groups: tuple

    @classmethod
    def of(cls, devices: Sequence, v_block: int) -> "CardLayout":
        devices = tuple(devices)
        return cls(devices, int(v_block), card_groups(devices))

    @property
    def cards(self) -> tuple:
        """Each card's device, card 0 the home (shard 0's)."""
        return tuple(self.devices[g[0]] for g in self.groups)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    @property
    def v_pad(self) -> int:
        return self.v_block * len(self.devices)

    def rows(self, c: int) -> int:
        """The rows of card c's tensor."""
        return len(self.groups[c]) * self.v_block

    def place(self, s: int) -> tuple:
        """(card, position among the card's shards) of shard s."""
        for c, g in enumerate(self.groups):
            if s in g:
                return c, g.index(s)
        raise IndexError(f"shard {s} of {len(self.devices)}")

    def block(self, tensors: Sequence[torch.Tensor], s: int) -> torch.Tensor:
        """Shard s's v_block rows, a view of its card's tensor of
        ``tensors`` (one a card)."""
        c, i = self.place(s)
        vb = self.v_block
        return tensors[c][i * vb:(i + 1) * vb]

    def locate(self, rows: torch.Tensor) -> tuple:
        """(card, row of the card's tensor) of each block-domain row of
        ``rows`` (int64, any shape), on ``rows``' device."""
        card_of, pos_of = _places(self, rows.device)
        shard = torch.div(rows, self.v_block, rounding_mode="floor")
        return (card_of[shard],
                pos_of[shard] * self.v_block + rows % self.v_block)

    def cut(self, full: torch.Tensor) -> list:
        """Each card's rows of ``full`` [n * v_block, ...] on the home, on
        that card (differentiable): ``full`` itself with one card."""
        if len(self.groups) == 1:
            return [full]
        blocks = blocks_on(full, self.v_block, self.devices)
        return [blocks[g[0]] if len(g) == 1
                else torch.cat([blocks[s] for s in g]) for g in self.groups]

    def replicate(self, t: torch.Tensor) -> list:
        """``t`` on each card (differentiable copies as a tree,
        ``placement.replicate``; ``t`` itself on its own device)."""
        copies = replicate(t, self.cards)
        return [copies[card] for card in self.cards]

    def join(self, parts: Sequence[torch.Tensor], dim: int = 0
             ) -> torch.Tensor:
        """The cards' tensors ``parts`` (card c's rows along ``dim``) on the
        home in block order (differentiable; ``cut``'s inverse): ``parts[0]``
        itself with one card."""
        if len(self.groups) == 1:
            return parts[0]
        vb, home = self.v_block, self.home
        blocks = []
        for s in range(len(self.devices)):
            c, i = self.place(s)
            blocks.append(parts[c].narrow(dim, i * vb, vb).to(home))
        return torch.cat(blocks, dim=dim)


@functools.lru_cache(maxsize=None)
def _places(layout: CardLayout, device: torch.device) -> tuple:
    """(card, position) of each shard as int64 tensors on ``device``, made
    once a layout and device: a copy from the host's memory would wait for
    the device's queued work each call."""
    places = [layout.place(s) for s in range(len(layout.devices))]
    return tuple(torch.tensor(v, dtype=torch.int64, device=device)
                 for v in zip(*places))


@dataclasses.dataclass(frozen=True, eq=False)
class CardRows:
    """A block-domain state [n * v_block, F] as one tensor a card of
    ``layout`` (card c's [rows(c), F] on ``layout.cards[c]``)."""

    layout: CardLayout
    tensors: tuple

    def __post_init__(self):
        if len(self.tensors) != len(self.layout.groups):
            raise ValueError(f"{len(self.tensors)} tensors for "
                             f"{len(self.layout.groups)} cards")
        for c, (t, card) in enumerate(zip(self.tensors, self.layout.cards)):
            if t.device != card or t.shape[0] != self.layout.rows(c):
                raise ValueError(
                    f"card {c}: a tensor of {t.shape[0]} rows on {t.device},"
                    f" expected {self.layout.rows(c)} rows on {card}")

    @property
    def shape(self) -> torch.Size:
        """The whole block domain's shape, [n * v_block, ...]."""
        return torch.Size((self.layout.v_pad,) + self.tensors[0].shape[1:])

    def block(self, s: int) -> torch.Tensor:
        """Shard s's v_block rows, a view of its card's tensor."""
        return self.layout.block(self.tensors, s)

    def map(self, fn: Callable, *others: "CardRows",
            consts: Sequence[Sequence] = ()) -> "CardRows":
        """``fn(t, *others' tensors, *consts' entries)`` once a card, each
        of ``consts`` a sequence of one value a card (``CardLayout.cut``'s,
        ``placement.replicate``'s)."""
        for o in others:
            if o.layout != self.layout:
                raise ValueError("CardRows of another layout")
        return CardRows(self.layout, tuple(
            fn(t, *(o.tensors[c] for o in others), *(k[c] for k in consts))
            for c, t in enumerate(self.tensors)))

    @classmethod
    def from_home(cls, full: torch.Tensor, layout: CardLayout) -> "CardRows":
        """``full`` [n * v_block, F] on the home, cut to the cards."""
        return cls(layout, tuple(layout.cut(full)))

    def to_home(self) -> torch.Tensor:
        """The state [n * v_block, F] on the home."""
        return self.layout.join(self.tensors)
