// The serving launchers' one argument: a packed array of int64 words, read
// in order. A pointer or an int takes a word; a float32 takes its bits in
// a word's low 32 (ops/_build.py `launch` and `f32` pack them so). One
// packed argument, as the ring launchers take, so that the host's call
// converts one pointer.

#pragma once

#include <cstdint>
#include <cstring>

struct ArgReader {
  const int64_t* p;

  template <class T>
  T* ptr() { return reinterpret_cast<T*>(*p++); }

  int i() { return static_cast<int>(*p++); }

  float f() {
    const uint32_t bits = static_cast<uint32_t>(*p++);
    float v;
    memcpy(&v, &bits, sizeof v);
    return v;
  }
};
