from .ber import BerTest, BerTestParameters, CodeStatistics, Statistics  # noqa: F401
from .channel import AwgnChannel  # noqa: F401
from .factory import BerTestBuilder  # noqa: F401
from .modulation import Bpsk  # noqa: F401
