// 32-bit carry-chain primitives, namespace cc: the Montgomery products of
// csrc/mont_cc.cuh and the Goldilocks ops of csrc/gl64.cuh run on them.
//
// On the card each primitive is one PTX instruction, and the carry flag
// passes from one to the next: they are volatile asm, which nvcc keeps in
// order, and nothing nvcc emits between them writes the flag.  A host
// compiler gets the same primitives over an explicit flag, so the
// arithmetic can be checked without a card.

#pragma once

#include <stdint.h>

namespace cc {

#ifdef __CUDACC__
#define CC_HD __device__ __forceinline__

#define CC_OP2(NAME, INSN)                                                   \
    CC_HD uint32_t NAME(uint32_t a, uint32_t b) {                            \
        uint32_t r;                                                          \
        asm volatile(INSN " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));        \
        return r;                                                            \
    }
#define CC_OP3(NAME, INSN)                                                   \
    CC_HD uint32_t NAME(uint32_t a, uint32_t b, uint32_t c) {                \
        uint32_t r;                                                          \
        asm volatile(INSN " %0, %1, %2, %3;"                                 \
                     : "=r"(r)                                               \
                     : "r"(a), "r"(b), "r"(c));                              \
        return r;                                                            \
    }

CC_OP2(add_cc, "add.cc.u32")
CC_OP2(addc_cc, "addc.cc.u32")
CC_OP2(addc, "addc.u32")
CC_OP2(sub_cc, "sub.cc.u32")
CC_OP2(subc_cc, "subc.cc.u32")
CC_OP2(subc, "subc.u32")
CC_OP3(mad_lo_cc, "mad.lo.cc.u32")
CC_OP3(madc_lo_cc, "madc.lo.cc.u32")
CC_OP3(mad_hi_cc, "mad.hi.cc.u32")
CC_OP3(madc_hi_cc, "madc.hi.cc.u32")
CC_OP3(madc_hi, "madc.hi.u32")

#undef CC_OP2
#undef CC_OP3

CC_HD uint32_t mul_hi(uint32_t a, uint32_t b) { return __umulhi(a, b); }

#else  // a host compiler: the same primitives over an explicit carry flag
#define CC_HD inline

inline uint32_t& flag() {
    static thread_local uint32_t f = 0;
    return f;
}

// a + b + k, the carry out to the flag if `set`
inline uint32_t carry_add(uint64_t s, bool set) {
    if (set) flag() = (uint32_t)(s >> 32);
    return (uint32_t)s;
}


inline uint64_t wide(uint32_t a, uint32_t b) { return (uint64_t)a * b; }

inline uint32_t add_cc(uint32_t a, uint32_t b) {
    return carry_add((uint64_t)a + b, true);
}
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
    return carry_add((uint64_t)a + b + flag(), true);
}
inline uint32_t addc(uint32_t a, uint32_t b) {
    return carry_add((uint64_t)a + b + flag(), false);
}
// a - b as the card computes it, a + ~b + 1, and with a borrow in,
// a + ~b + flag: the flag a subtraction leaves is the carry of that sum,
// the borrow inverted, so a subc after an add.cc computes a - b - 1 + carry
// here as on the card, and a chain that mixes the two shows it
inline uint32_t sub_cc(uint32_t a, uint32_t b) {
    return carry_add((uint64_t)a + (uint32_t)~b + 1, true);
}
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
    return carry_add((uint64_t)a + (uint32_t)~b + flag(), true);
}
inline uint32_t subc(uint32_t a, uint32_t b) {
    return carry_add((uint64_t)a + (uint32_t)~b + flag(), false);
}
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return carry_add((uint64_t)(uint32_t)wide(a, b) + c, true);
}
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return carry_add((uint64_t)(uint32_t)wide(a, b) + c + flag(), true);
}
inline uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return carry_add((wide(a, b) >> 32) + c, true);
}
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return carry_add((wide(a, b) >> 32) + c + flag(), true);
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
    return carry_add((wide(a, b) >> 32) + c + flag(), false);
}
inline uint32_t mul_hi(uint32_t a, uint32_t b) {
    return (uint32_t)(wide(a, b) >> 32);
}
#endif  // __CUDACC__

}  // namespace cc
