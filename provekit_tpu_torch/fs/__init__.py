from .sponge import SkyscraperSponge
from .transcript import DomainSeparator, ProverState, VerifierState

__all__ = ["SkyscraperSponge", "DomainSeparator", "ProverState", "VerifierState"]
