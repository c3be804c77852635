from .ber import BerTest, BerTestParameters, CodeStatistics, Statistics  # noqa: F401
from .channel import AwgnChannel  # noqa: F401
from .factory import BerTestBuilder, Modulation  # noqa: F401
from .interleaving import Interleaver  # noqa: F401
from .modulation import Bpsk, Psk8  # noqa: F401
from .puncturing import Puncturer  # noqa: F401
