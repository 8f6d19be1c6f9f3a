/* A JPEG writer on libjpeg(-turbo)'s compressor, for the golden streams
 * that PIL's save cannot write: arithmetic coding, custom progressive
 * scripts, any sampling factors, CMYK and YCCK with or without the Adobe
 * marker, lossless (SOF3) and 12-bit samples.  Built and run by
 * regenerate_jpeg.py only; the tests read the streams it wrote.
 *
 *   jpeg_writer IN.raw OUT.jpg W H NC [key=value ...]
 *
 * IN.raw holds H * W * NC bytes (NC = 1 grey, 3 RGB, 4 CMYK).  Keys:
 *   q=N           quality (default 80)
 *   cs=NAME       JPEG colour space: grey, rgb, ycc, cmyk, ycck
 *   samp=HxV,...  sampling factors, one per component
 *   arith=1       arithmetic coding
 *   dac=L,U,K     arithmetic conditioning (DC L and U, AC Kx)
 *   prog=1        libjpeg's simple progressive script
 *   scans=S;...   a script: each scan "comps/Ss/Se/Ah/Al", comps as digits
 *   restart=N     restart interval in MCUs
 *   opt=1         optimized Huffman tables
 *   adobe=0|1     write the Adobe APP14 marker (or not)
 *   jfif=0|1      write the JFIF APP0 marker (or not)
 *   lossless=P,T  lossless with predictor P and point transform T
 *                 (needs libjpeg-turbo >= 3, built with -DTURBO3)
 *   prec=N        sample precision: 12 (DCT) or 16 (lossless), -DTURBO3
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

#ifdef TURBO3
/* libjpeg-turbo 3 entry points the 2.x header lacks */
void jpeg_enable_lossless(j_compress_ptr, int, int);
JDIMENSION jpeg12_write_scanlines(j_compress_ptr, short **, JDIMENSION);
JDIMENSION jpeg16_write_scanlines(j_compress_ptr, unsigned short **,
                                  JDIMENSION);
#endif

static jpeg_scan_info scans[64];

static int parse_scans(const char *s) {
  int n = 0;
  while (*s && n < 64) {
    jpeg_scan_info *si = &scans[n++];
    si->comps_in_scan = 0;
    while (*s >= '0' && *s <= '9') si->component_index[si->comps_in_scan++] = *s++ - '0';
    if (sscanf(s, "/%d/%d/%d/%d", &si->Ss, &si->Se, &si->Ah, &si->Al) != 4) {
      fprintf(stderr, "bad scan: %s\n", s);
      exit(2);
    }
    while (*s && *s != ';') ++s;
    if (*s == ';') ++s;
  }
  return n;
}

int main(int argc, char **argv) {
  if (argc < 6) {
    fprintf(stderr, "usage: %s IN.raw OUT.jpg W H NC [key=value ...]\n", argv[0]);
    return 2;
  }
  int W = atoi(argv[3]), H = atoi(argv[4]), NC = atoi(argv[5]);
  size_t n = (size_t)W * H * NC;
  unsigned char *px = malloc(n);
  FILE *f = fopen(argv[1], "rb");
  if (!f || fread(px, 1, n, f) != n) {
    fprintf(stderr, "cannot read %s\n", argv[1]);
    return 2;
  }
  fclose(f);

  struct jpeg_compress_struct c;
  struct jpeg_error_mgr jerr;
  c.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&c);
  FILE *out = fopen(argv[2], "wb");
  jpeg_stdio_dest(&c, out);
  c.image_width = W;
  c.image_height = H;
  c.input_components = NC;
  c.in_color_space = NC == 1 ? JCS_GRAYSCALE : NC == 3 ? JCS_RGB : JCS_CMYK;
  int prec = 8;
  for (int i = 6; i < argc; ++i)
    if (!strncmp(argv[i], "prec=", 5)) prec = atoi(argv[i] + 5);
  c.data_precision = prec;
  jpeg_set_defaults(&c);
#ifdef TURBO3
  /* first, as it resets the colour space and the sampling factors */
  for (int i = 6; i < argc; ++i)
    if (!strncmp(argv[i], "lossless=", 9)) {
      int psv = 0, pt = 0;
      sscanf(argv[i] + 9, "%d,%d", &psv, &pt);
      jpeg_enable_lossless(&c, psv, pt);
    }
#endif
  int quality = 80, nscans = 0, prog = 0, adobe = -1, jfif = -1;
  int psv = 0, pt = 0;
  for (int i = 6; i < argc; ++i) {
    char *k = argv[i], *v = strchr(k, '=');
    if (!v) return 2;
    *v++ = 0;
    if (!strcmp(k, "q")) {
      quality = atoi(v);
    } else if (!strcmp(k, "cs")) {
      J_COLOR_SPACE cs = !strcmp(v, "grey") ? JCS_GRAYSCALE
                         : !strcmp(v, "rgb") ? JCS_RGB
                         : !strcmp(v, "ycc") ? JCS_YCbCr
                         : !strcmp(v, "cmyk") ? JCS_CMYK
                                              : JCS_YCCK;
      jpeg_set_colorspace(&c, cs);
    } else if (!strcmp(k, "samp")) {
      for (int ci = 0; ci < c.num_components && *v; ++ci) {
        c.comp_info[ci].h_samp_factor = atoi(v);
        v = strchr(v, 'x') + 1;
        c.comp_info[ci].v_samp_factor = atoi(v);
        while (*v && *v != ',') ++v;
        if (*v) ++v;
      }
    } else if (!strcmp(k, "arith")) {
      c.arith_code = atoi(v);
    } else if (!strcmp(k, "dac")) {
      int L, U, K;
      sscanf(v, "%d,%d,%d", &L, &U, &K);
      for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
        c.arith_dc_L[t] = L;
        c.arith_dc_U[t] = U;
        c.arith_ac_K[t] = K;
      }
    } else if (!strcmp(k, "prog")) {
      prog = atoi(v);
    } else if (!strcmp(k, "scans")) {
      nscans = parse_scans(v);
    } else if (!strcmp(k, "restart")) {
      c.restart_interval = atoi(v);
    } else if (!strcmp(k, "opt")) {
      c.optimize_coding = atoi(v);
    } else if (!strcmp(k, "adobe")) {
      adobe = atoi(v);
    } else if (!strcmp(k, "jfif")) {
      jfif = atoi(v);
    } else if (!strcmp(k, "lossless")) {
      sscanf(v, "%d,%d", &psv, &pt);
    } else if (strcmp(k, "prec")) {
      fprintf(stderr, "unknown key %s\n", k);
      return 2;
    }
  }
  if (!psv) jpeg_set_quality(&c, quality, TRUE);
  if (prog) jpeg_simple_progression(&c);
  if (nscans) {
    c.scan_info = scans;
    c.num_scans = nscans;
  }
  if (adobe >= 0) c.write_Adobe_marker = adobe;
  if (jfif >= 0) c.write_JFIF_header = jfif;
#ifndef TURBO3
  if (psv || prec != 8) {
    fprintf(stderr, "lossless and 12/16-bit need -DTURBO3\n");
    return 2;
  }
#endif
  jpeg_start_compress(&c, TRUE);
  size_t stride = (size_t)W * NC;
  if (prec == 8) {
    for (int y = 0; y < H; ++y) {
      JSAMPROW row = px + y * stride;
      jpeg_write_scanlines(&c, &row, 1);
    }
#ifdef TURBO3
  } else {
    unsigned short *wide = malloc(stride * sizeof(unsigned short));
    for (int y = 0; y < H; ++y) {
      for (size_t x = 0; x < stride; ++x)
        wide[x] = (unsigned short)(px[y * stride + x] << (prec - 8));
      if (prec == 12)
        jpeg12_write_scanlines(&c, (short **)&wide, 1);
      else
        jpeg16_write_scanlines(&c, &wide, 1);
    }
    free(wide);
#endif
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  free(px);
  return 0;
}
