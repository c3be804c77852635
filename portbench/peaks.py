"""The peaks that roofline shares are stated against: NVIDIA's data sheet
for the H100 SXM (dense rates, at its full 700 W power limit). A card set
below that limit runs slower under load; the harness prints the card's
limit beside the shares."""

#: float32 operations per second outside the tensor cores (an FMA two)
F32_OPS_PER_S = 67e12
#: HBM3 bytes per second
HBM_BYTES_PER_S = 3.35e12
