"""Runtime configuration (reference: src/Config.hpp:31-66)."""

from __future__ import annotations

from dataclasses import dataclass

MEM = "mem"
GREEDY = "greedy"


@dataclass
class KaijuConfig:
    mode: str = GREEDY
    max_matches_SI: int = 20
    max_match_ids: int = 20
    max_match_acc: int = 20
    verbose: bool = False
    debug: bool = False
    seg: bool = True
    input_is_protein: bool = False
    min_fragment_length: int = 11
    mismatches: int = 3
    min_score: int = 65
    seed_length: int = 7
    use_Evalue: bool = True
    min_Evalue: float = 0.01
    # kaijux/kaijup: no taxonomy, report DB sequence names
    # (reference: src/ConsumerThreadx.cpp, ConsumerThreadp.cpp)
    taxonomy_free: bool = False

    def cap_sig(self) -> str:
        """Short signature of the knobs that shape device-lane capacity
        needs; CapStore keys learned caps by it so one outlier
        configuration cannot inflate every later run's padded shapes."""
        parts = (
            self.min_fragment_length, self.min_score, self.mismatches,
            self.seed_length, self.max_matches_SI, int(self.seg),
            int(self.input_is_protein),
        )
        return "c" + "-".join(str(p) for p in parts)

    def validate(self) -> None:
        if self.mode not in (MEM, GREEDY):
            raise ValueError(f"invalid mode {self.mode}")
        if self.mode == MEM and self.use_Evalue:
            # kaiju.cpp:202 rejects -E with MEM; `-a mem` auto-disables
            raise ValueError("E-value filtering is only possible in Greedy mode")
        if self.seed_length < 7:
            raise ValueError("Seed length must be >= 7.")
        if self.min_score <= 0 or self.min_fragment_length <= 0:
            raise ValueError("min_score/min_fragment_length must be positive")
