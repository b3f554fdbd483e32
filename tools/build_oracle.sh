#!/bin/bash
# Build the HM reference encoder/decoder from /root/reference (read-only) into
# /root/repo/.oracle/ (gitignored).  These binaries are the bit-exactness
# oracle for this codec: our encoder's streams must decode
# bit-exactly in the HM decoder and vice versa (SURVEY.md section 4).
set -e
REF=/root/reference/source
OUT=/root/repo/.oracle
mkdir -p $OUT/obj $OUT/bin

CXX=${CXX:-g++}
FLAGS="-O2 -std=gnu++03 -w -fpermissive -DMSYS_LINUX -D_LARGEFILE64_SOURCE -D_FILE_OFFSET_BITS=64 -DMSYS_UNIX_LARGEFILE -I$OUT/patched -I$REF/Lib -I$REF/Lib/TLibCommon -I$REF/Lib/TLibEncoder -I$REF/Lib/TLibDecoder"

compile() {
  local src=$1
  local obj=$OUT/obj/$(echo "${src#$REF/}" | tr / _).o
  if [ ! -f "$obj" ] || [ "$src" -nt "$obj" ]; then
    echo "CXX ${src#$REF/}"
    if [[ "$src" == *.c ]]; then
      gcc -O2 -w -c "$src" -o "$obj" -I$REF/Lib
    else
      $CXX $FLAGS -c "$src" -o "$obj"
    fi
  fi
  OBJS="$OBJS $obj"
}

# TComTrQuant.cpp relies on pre-standard for-loop variable scoping (variables
# from an earlier `for(Int i=...)` reused after the loop); modern g++ rejects
# it.  Patch a copy (reference is read-only) by hoisting the declarations.
mkdir -p $OUT/patched/TLibEncoder
# AnnexBwrite.h binds an rvalue string to a non-const reference; take a copy.
sed -e 's/string &P = nalu.m_nalUnitData.str();/string P = nalu.m_nalUnitData.str();/' \
    /root/reference/source/Lib/TLibEncoder/AnnexBwrite.h > $OUT/patched/TLibEncoder/AnnexBwrite.h
sed -e 's/^  Int iScanPos;$/  Int iScanPos; Int iCGScanPos; Int scanPos;/' \
    -e 's/^  for (Int iCGScanPos = uiCGNum-1;/  for (iCGScanPos = uiCGNum-1;/' \
    -e 's/^  for ( Int scanPos = 0; scanPos < iBestLastIdxP1;/  for ( scanPos = 0; scanPos < iBestLastIdxP1;/' \
    /root/reference/source/Lib/TLibCommon/TComTrQuant.cpp > $OUT/patched/TComTrQuant.cpp

OBJS=""
for src in $REF/Lib/TLibCommon/*.cpp $REF/Lib/TLibVideoIO/*.cpp \
           $REF/Lib/TAppCommon/*.cpp $REF/Lib/libmd5/*.c; do
  if [[ "$src" == */TComTrQuant.cpp ]]; then src=$OUT/patched/TComTrQuant.cpp; fi
  compile "$src"
done
COMMON_OBJS="$OBJS"

OBJS=""
for src in $REF/Lib/TLibEncoder/*.cpp $REF/App/TAppEncoder/*.cpp; do
  compile "$src"
done
ENC_OBJS="$OBJS"

OBJS=""
for src in $REF/Lib/TLibDecoder/*.cpp $REF/App/TAppDecoder/*.cpp; do
  compile "$src"
done
DEC_OBJS="$OBJS"

# --- traced decoder (CABAC symbol trace to /tmp/hm_trace.txt) -------------
# ENC_DEC_TRACE build: patch TComRom.h to enable the macro and TComRom.cpp
# to open the trace file (the reference never initializes g_hTrace).
if [ "${BUILD_TRACED:-1}" = 1 ]; then
  # mirror the sources so the patched TComRom.h wins same-dir quoted includes
  TSRC=$OUT/traced-src
  if [ ! -d $TSRC ]; then
    mkdir -p $TSRC
    cp -r $REF/Lib $TSRC/Lib
    cp -r $REF/App/TAppDecoder $TSRC/TAppDecoder
  fi
  sed -e 's/#define ENC_DEC_TRACE 0/#define ENC_DEC_TRACE 1/' \
      -e 's/#define COUNTER_END      0 /#define COUNTER_END      (UInt64(1)<<63) /' \
      /root/reference/source/Lib/TLibCommon/TComRom.h > $TSRC/Lib/TLibCommon/TComRom.h
  sed -e 's|FILE\*  g_hTrace = NULL;|FILE*  g_hTrace = fopen("/tmp/hm_trace.txt", "w");|' \
      /root/reference/source/Lib/TLibCommon/TComRom.cpp > $TSRC/Lib/TLibCommon/TComRom.cpp
  cp $OUT/patched/TComTrQuant.cpp $TSRC/Lib/TLibCommon/TComTrQuant.cpp
  mkdir -p $OUT/obj-trace
  TFLAGS="-O1 -std=gnu++03 -w -fpermissive -DMSYS_LINUX -D_LARGEFILE64_SOURCE -D_FILE_OFFSET_BITS=64 -DMSYS_UNIX_LARGEFILE -I$TSRC/Lib -I$TSRC/Lib/TLibCommon -I$TSRC/Lib/TLibDecoder"
  TOBJS=""
  for src in $TSRC/Lib/TLibCommon/*.cpp $TSRC/Lib/TLibVideoIO/*.cpp \
             $TSRC/Lib/TAppCommon/*.cpp $TSRC/Lib/TLibDecoder/*.cpp \
             $TSRC/TAppDecoder/*.cpp; do
    obj=$OUT/obj-trace/$(echo "${src}" | tr / _).o
    if [ ! -f "$obj" ] || [ "$src" -nt "$obj" ]; then
      echo "CXX(traced) $(basename $src)"
      $CXX $TFLAGS -c "$src" -o "$obj"
    fi
    TOBJS="$TOBJS $obj"
  done
  MD5OBJ=$OUT/obj-trace/libmd5.o
  [ -f $MD5OBJ ] || gcc -O2 -w -c $REF/Lib/libmd5/libmd5.c -o $MD5OBJ -I$REF/Lib
  echo "LINK TAppDecoderTrace"
  $CXX $TOBJS $MD5OBJ -o $OUT/bin/TAppDecoderTrace -ldl -lpthread
fi

echo "LINK TAppEncoder"
$CXX $ENC_OBJS $COMMON_OBJS -o $OUT/bin/TAppEncoder -ldl -lpthread
echo "LINK TAppDecoder"
# decoder also needs encoder-lib objects? HM links TLibEncoder into decoder? No.
$CXX $DEC_OBJS $COMMON_OBJS -o $OUT/bin/TAppDecoder -ldl -lpthread
echo OK
