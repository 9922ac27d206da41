from .esmm import ESMM
from .mmoe import MMOE
from .ple import PLE
from .sharedbottom import SharedBottom

__all__ = ["ESMM", "MMOE", "PLE", "SharedBottom"]
