// Division of 32-bit indices by a divisor fixed for a launch, as a
// multiply-high by a reciprocal made on the host (Granlund and Montgomery),
// for the kernels that find a row from a flat index: no division per
// element on the card.
#pragma once

namespace int_div {

// n / d for n < 2^31 as (umulhi(n, mul) >> shr) (d > 1) or n (d == 1).
struct Divisor {
  unsigned d, mul, shr;
};

__device__ __forceinline__ unsigned div_by(unsigned n, Divisor dv) {
  return dv.d == 1 ? n : __umulhi(n, dv.mul) >> dv.shr;
}

// The reciprocal of d for div_by: mul = ceil(2^p / d) with p = 31 +
// ceil(log2 d), exact for every n < 2^31.
inline Divisor divisor(unsigned d) {
  Divisor dv{d, 0u, 0u};
  if (d > 1) {
    unsigned l = 0;
    while ((1ull << l) < d) ++l;
    const unsigned p = 31 + l;
    dv.mul = (unsigned)(((1ull << p) + d - 1) / d);
    dv.shr = p - 32;
  }
  return dv;
}

}  // namespace int_div
